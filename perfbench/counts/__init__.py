"""Operation and byte counts behind the benchmark's ``mfu`` and
``*_roofline`` metrics, and the card's published peaks."""
