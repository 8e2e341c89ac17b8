"""A configuration's weights, drawn on the device from the seed in one
call and handed alike to the port and to the reference.

Every conv kernel is a truncated normal (cut at two standard deviations,
as flax's initializers, rescaled to keep the variance) with the
standard deviation its configuration's ``init`` section gives:
``sqrt(gain / fan_in)`` (``gain``, or ``gain_by_prefix`` for the keys
with a listed prefix), or a fixed ``std_by_prefix``.  Conv biases are 0 except the head priors the reference module
states; BatchNorm starts at scale 1, bias 0, mean 0 and variance 1.
"""

from __future__ import annotations

import math

import torch

from perfbench.harness import seeds

TRUNC_STD = 0.87962566103423978     # std of a unit normal cut at +-2


def shapes(reference, cfg: dict) -> dict:
    """``{state-dict key: shape}`` of the reference model."""
    with torch.device("meta"):
        model = reference.build(cfg)
    return {k: tuple(t.shape) for k, t in model.state_dict().items()}


def kernel_std(key: str, shape: tuple, init: dict) -> float:
    for prefix, std in init.get("std_by_prefix", {}).items():
        if key.startswith(prefix):
            return std
    gain = init["gain"]
    for prefix, g in init.get("gain_by_prefix", {}).items():
        if key.startswith(prefix):
            gain = g
    return math.sqrt(gain / (shape[1] * shape[2] * shape[3]))


@torch.no_grad()
def draw(reference, cfg: dict, seed: int, device) -> dict:
    """``{key: float32 tensor on device}`` for every state-dict entry."""
    table = shapes(reference, cfg)
    kernels = [k for k, s in table.items() if len(s) == 4]
    total = sum(math.prod(table[k]) for k in kernels)
    flat = torch.empty(total, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0,
                                generator=seeds.torch_generator(
                                    seed, "weights", device))
    out, at = {}, 0
    for key, shape in table.items():
        if len(shape) == 4:
            n = math.prod(shape)
            std = kernel_std(key, shape, cfg["init"])
            out[key] = (flat[at:at + n] * (std / TRUNC_STD)).view(shape)
            at += n
        elif key.endswith("running_var") or (
                key.endswith(".weight") and len(shape) == 1):
            out[key] = torch.ones(shape, device=device)
        else:
            out[key] = torch.zeros(shape, device=device)
    for key, values in reference.head_bias_priors(cfg).items():
        out[key] = torch.tensor(values, dtype=torch.float32, device=device)
    return out


@torch.no_grad()
def unit_variance(reference, cfg: dict, weights: dict,
                  images: torch.Tensor) -> dict:
    """LSUV (Mishkin and Matas, arXiv:1511.06422) for an eval-mode model
    whose BatchNorm holds its initial statistics: in one eval forward of
    the reference on ``images`` (uint8 NHWC), each conv's kernel is
    rescaled, in the order the forward meets them, so that its output
    before the bias has the standard deviation 1, or the one that a
    prefix of ``eval_std_by_prefix`` names.  Where the
    configuration gives ``eval_pass_share``, the bias of each channel that
    the reference's ``score_channels`` lists is then set so that this
    share of its outputs on ``images`` is at least 0.  Returns a new
    dict."""
    init = cfg["init"]
    score_channels = (reference.score_channels(cfg)
                      if "eval_pass_share" in init else {})
    model = reference.build(cfg).to(images.device)
    model.load_state_dict(weights)
    model.eval()

    def hook(name):
        target = 1.0
        for prefix, std in init.get("eval_std_by_prefix", {}).items():
            if name.startswith(prefix):
                target = std

        def rescale(mod, inputs, out):
            bias = 0.0 if mod.bias is None else mod.bias[None, :, None, None]
            pre = out - bias
            factor = target / pre.std().clamp(min=1e-30)
            mod.weight.mul_(factor)
            pre = pre * factor
            for c in score_channels.get(name, ()):
                mod.bias[c] = -torch.quantile(
                    pre[:, c].flatten().double(),
                    1.0 - init["eval_pass_share"]).float()
            return pre + (0.0 if mod.bias is None
                          else mod.bias[None, :, None, None])
        return rescale

    hooks = [m.register_forward_hook(hook(n)) for n, m in
             model.named_modules() if type(m).__name__ == "Conv"]
    try:
        model(images.float() / 255.0)
    finally:
        for h in hooks:
            h.remove()
    scaled = model.state_dict()
    return {k: scaled[k].clone() if k.endswith("weight") and v.dim() == 4
            or k[:-len(".bias")] in score_channels else v
            for k, v in weights.items()}
