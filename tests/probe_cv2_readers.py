"""Probes of cv2.imread on damaged or unusual files against the port's
reader, counting where the two agree.  Not a test: the counts are the
record behind ROADMAP §C's entries.

    python tests/probe_cv2_readers.py fax [--seeds 60]
    python tests/probe_cv2_readers.py gif [--files 3000]
    python tests/probe_cv2_readers.py avif [--files 400]
    python tests/probe_cv2_readers.py avif_depth [--files 400]
    python tests/probe_cv2_readers.py avif_sequence [--files 400]
    python tests/probe_cv2_readers.py avif_layers [--files 400]
    python tests/probe_cv2_readers.py avif_inter [--files 400]

``fax``: CCITT Group 3 (1-D, 2-D, with and without fill bits), Group 4
and RLE files that the system libtiff writes (the writer of
``test_torch_port_tiff.py``), 24 rows of 61, 200 or 1728 pixels, in
strips of 8 or 24 rows or 64x16 tiles; in each, 40 times, one strip or
tile cut to a random byte count or zeroed from a random byte.  Prints,
per compression, the files and how many the port reads as cv2 does.

``gif``: one-frame GIFs of up to 8x4 pixels whose LZW data hold a random
number of the frame's pixels, the End code, then 1 to 9 seeded random
bytes.  cv2 decodes every file in two fresh processes (in file order and
in reverse); prints how many decodes differ between them, and how many
files the port reads as cv2 does, split by which side refuses.

``avif``: seeded images (smooth, noise, or blocks of a few colours) of 1
to 200 pixels a side through Pillow's AVIF encoder (libavif over aom)
under random aom options (each tool of the decoder on or off, 64 or 128
superblocks, delta q, adaptive quantization, quantizer matrices, tiles,
film grain (one of libaom's 16 test vectors), palette, intra block copy,
restoration), subsamplings, qualities and speeds, a quarter of them with
the colr box's matrix and range redrawn, a tenth with 1 to 3 bits of
their AV1 data flipped; then a fifth as many superres key frames
(denominators 9 to 16, restoration on or off, two tile columns where
the coded width allows, a film grain test vector in a quarter) through
the system libaom by ``tools/format_files.py::aom_encode``, boxed by
``avif_bytes``, a tenth with bits flipped.  Prints how many files the
port reads as cv2 does, and for the rest which side refuses and why.

``avif_depth``: seeded 10- and 12-bit key frames of 1 to 200 pixels a
side (smooth, noise or screen content: blocks of a few colours or a
page of glyphs) through the system libaom by ``aom_encode``: every
subsampling, 64 or 128 superblocks, tile columns, restoration, superres
(a fifth), film grain (one of libaom's 16 test vectors, a fifth),
libaom's screen tuning with palettes and intra block copy (a third),
quantizer matrices, delta q, lossless; boxed by ``avif_bytes`` with a
random nclx (every matrix cv2 reads, both ranges) and a tenth with bits
flipped.  Prints the counts as ``avif`` does.

``avif_sequence``: Pillow's image sequences (2 to 5 frames, RGB or RGBA,
random quality, speed and subsampling), a third with the meta item
pointed at the second sample; and files with an alpha item, a half of
them premultiplied (a prem reference): colour and alpha through
``aom_encode`` at 8, 10 or 12 bits (limited-range alpha, an alpha of
another depth or size now and then) or through Pillow, with a random
nclx; a tenth of all with bits flipped.  Prints the counts as ``avif``
does.

``avif_layers``: seeded layered items through the system libaom's
spatial layers (``aom_encode``'s ``layers``): crops of the 500x375
fixture of 32 to 200 pixels a side, 2 or 3 layers, good-quality or
realtime usage, a cq-level per layer (seven in ten), the lower layers
scaled (one half .. four fifths, four in ten), 8, 10 or 12 bits, every
subsampling; a fifth with an lsel of a random layer, a tenth with bits
flipped.  Each encode runs in a child process (libaom 3.6's encoder
crashes on some high-bitdepth layered configurations; those are counted
apart).  Prints the counts as ``avif`` does.

``avif_inter``: four kinds in turn, each encoded in a child by the
system libaom (``aom_encode``), seeded: frame sequences (2 to 6 crops of
the 500x375 fixture of 32 to 160 samples a side, each moving by its own
step) coded through libaom's frame resizing (8/9 .. 8/16) or superres
(9 .. 16), compound tools on or off, 8, 10 or 12 bits, every
subsampling but 4:0:0; realtime or good-quality sequences of a mosaic
or of moving crops with one inter frame header's global motion
rewritten (``with_global_motion``: identity, translation, rotation and
zoom or affine for one or every reference, a model whose vectors round
to zero or one drawn at random, shears valid or not); sequences with
error-resilient frames (per frame, ``AOM_EFLAG_ERROR_RESILIENT``) and
one temporal unit dropped; grids of 1x1 .. 2x3 tiles of 64 to 80
samples with an alpha item on each tile (``avif_grid_bytes``' alpha),
premultiplied or not, now and then a tile without alpha, one with two,
or alpha of another depth.  A tenth of all with bits flipped.  Prints
the counts as ``avif`` does.
"""

import argparse
import hashlib
import os
import struct
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]
os.environ.setdefault("OPENCV_LOG_LEVEL", "OFF")

from objectdetectionpl_tpu_torch.data import native  # noqa: E402
from objectdetectionpl_tpu_torch.data.formats import _tiff_ifd  # noqa: E402
from objectdetectionpl_tpu_torch.tools.format_files import (  # noqa: E402
    gif_blocks, gif_bytes, gif_lzw, set_tiff_counts)


def _port(path: str):
    try:
        return native.decode_image(path)
    except native.ImageError:
        return None


def fax(seeds: int) -> None:
    import cv2
    from test_torch_port_tiff import TIFF_WRITER
    tmp = Path(tempfile.mkdtemp(prefix="probe_fax_"))
    (tmp / "tw.c").write_text(TIFF_WRITER)
    subprocess.run(["cc", "-O1", str(tmp / "tw.c"), "-ltiff", "-o",
                    str(tmp / "tw")], check=True)
    codecs = {"G3 1-D": (3, 0), "G3 2-D": (3, 1), "G3 1-D fill": (3, 4),
              "G3 2-D fill": (3, 5), "G4": (4, None), "RLE": (2, None)}
    counts = Counter()
    path = str(tmp / "probe.tif")
    for seed in range(seeds):
        rng = np.random.RandomState(seed)
        w = (61, 200, 1728)[seed % 3]
        bits = (np.arange(w)[None] // rng.randint(1, 90, (24, 1)) % 2
                if seed % 2 == 0 else rng.rand(24, w) < rng.rand())
        for name, (comp, t4) in codecs.items():
            layout = ["rps=8"] if w > 1000 else \
                [["rps=8"], ["rps=24"], ["tw=64", "th=16"]][rng.randint(3)]
            fields = [f"w={w}", "h=24", "spp=1", "bps=1",
                      f"photo={rng.randint(2)}", f"comp={comp}", *layout]
            if t4 is not None:
                fields.append(f"t4={t4}")
            subprocess.run([str(tmp / "tw"), path, *fields],
                           input=np.packbits(bits, axis=1).tobytes(),
                           check=True)
            data = Path(path).read_bytes()
            tags, _ = _tiff_ifd(data)
            offs, cnts = tags.get(273) or tags[324], tags.get(279) or tags[325]
            for _ in range(40):
                i = rng.randint(len(offs))
                if rng.rand() < .5:
                    damaged = set_tiff_counts(data, [
                        rng.randint(1, cnts[i]) if k == i else None
                        for k in range(len(offs))])
                else:
                    at = offs[i] + rng.randint(cnts[i])
                    damaged = bytearray(data)
                    damaged[at:offs[i] + cnts[i]] = bytes(
                        offs[i] + cnts[i] - at)
                Path(path).write_bytes(bytes(damaged))
                ref, got = cv2.imread(path), _port(path)
                same = (ref is None and got is None) or (
                    ref is not None and got is not None
                    and np.array_equal(ref[..., ::-1], got))
                counts[name, "files"] += 1
                counts[name, "as cv2"] += same
    for name in codecs:
        print(f"{name}: {counts[name, 'as cv2']} of {counts[name, 'files']}"
              f" files read as cv2 reads them")


_DECODE = """
import hashlib, os, sys
import cv2
names = sorted(os.listdir(sys.argv[1]))
for n in (names[::-1] if sys.argv[2] == "reverse" else names):
    im = cv2.imread(os.path.join(sys.argv[1], n))
    print(n, "None" if im is None else hashlib.sha1(im.tobytes()).hexdigest())
"""


def gif(files: int) -> None:
    tmp = Path(tempfile.mkdtemp(prefix="probe_gif_"))
    for s in range(files):
        rng = np.random.RandomState(s)
        mcs = rng.randint(2, 9)
        w, h = rng.randint(1, 9), rng.randint(1, 5)
        idx = rng.randint(0, 1 << mcs, rng.randint(1, w * h + 1))
        data = gif_lzw(idx.astype(np.uint8).tobytes(), mcs) + \
            rng.randint(0, 256, rng.randint(1, 10)).astype(np.uint8).tobytes()
        frame = b"," + struct.pack("<HHHHB", 0, 0, w, h, 0) + bytes([mcs]) \
            + gif_blocks(data)
        table = rng.randint(0, 256, (1 << mcs, 3))
        (tmp / f"{s:05d}.gif").write_bytes(gif_bytes(w, h, [frame], table))
    runs = []
    for order in ("forward", "reverse"):
        out = subprocess.run([sys.executable, "-c", _DECODE, str(tmp), order],
                             check=True, capture_output=True, text=True)
        runs.append(dict(line.split() for line in out.stdout.splitlines()))
    print(f"{files} files; cv2's decodes differ between the two processes "
          f"on {sum(runs[0][n] != runs[1][n] for n in runs[0])}")
    split = Counter()
    for n, ref in runs[0].items():
        got = _port(str(tmp / n))
        mine = "None" if got is None else hashlib.sha1(
            np.ascontiguousarray(got[..., ::-1]).tobytes()).hexdigest()
        split["as cv2" if mine == ref else "cv2 refuses, the port reads"
              if ref == "None" else "the port refuses, cv2 reads"
              if mine == "None" else "both read, pixels differ"] += 1
    for k, v in sorted(split.items()):
        print(f"{k}: {v}")


AVIF_TOOLS = ("enable-cdef", "loopfilter-control", "enable-filter-intra",
              "enable-intra-edge-filter", "enable-cfl-intra",
              "enable-smooth-intra", "enable-paeth-intra",
              "enable-angle-delta", "enable-tx64", "enable-diagonal-intra",
              "enable-directional-intra", "enable-rect-tx",
              "enable-flip-idtx", "enable-rect-partitions",
              "enable-ab-partitions", "enable-1to4-partitions", "enable-qm",
              "enable-palette", "enable-intrabc", "enable-restoration",
              "reduced-tx-type-set", "enable-chroma-deltaq")


def avif(files: int) -> None:
    import io
    from PIL import Image
    tmp = Path(tempfile.mkdtemp(prefix="probe_avif_"))
    split = Counter()
    for s in range(files):
        rng = np.random.RandomState(s)
        h, w = rng.randint(1, 201), rng.randint(1, 201)
        kind = rng.choice(["smooth", "noise", "blocks"])
        if kind == "noise":
            img = rng.randint(0, 256, (h, w, 3))
        elif kind == "blocks":
            cols = rng.randint(0, 256, (rng.randint(2, 8), 3))
            img = cols[rng.randint(0, len(cols), (h // 8 + 1, w // 8 + 1))
                       .repeat(8, 0).repeat(8, 1)[:h, :w]]
        else:
            y, x = np.mgrid[0:h, 0:w]
            img = np.stack([x * 3, y * 4, (x + y) * 2], -1) % 256 + \
                rng.randint(0, 30, (h, w, 3))
        adv = {t: str(rng.randint(2)) for t in AVIF_TOOLS}
        adv["sb-size"] = str(rng.choice([64, 128]))
        adv["deltaq-mode"] = str(rng.randint(2))
        adv["aq-mode"] = str(rng.randint(4))
        if rng.rand() < 0.1:
            adv["film-grain-test"] = str(rng.randint(1, 17))
        sub = rng.choice(["4:2:0", "4:2:2", "4:4:4", "4:0:0"])
        if sub == "4:0:0":
            adv.pop("enable-chroma-deltaq")
        kw = dict(quality=int(rng.choice([0, 20, 40, 60, 80, 95, 100])),
                  speed=int(rng.choice([2, 4, 6, 8, 10])), subsampling=sub,
                  range=rng.choice(["full", "limited"]), advanced=adv)
        if rng.rand() < 0.2:
            kw.update(tile_cols=1, tile_rows=int(rng.randint(2)),
                      autotiling=False)
        out = io.BytesIO()
        try:
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                out, format="AVIF", **kw)
        except (OSError, ValueError):
            split["Pillow's encoder refuses the options"] += 1
            continue
        data = bytearray(out.getvalue())
        at = data.find(b"colrnclx")
        if rng.rand() < 0.25 and at > 0:
            data[at + 12:at + 14] = int(rng.choice(
                [0, 1, 2, 4, 5, 6, 7, 8, 9, 12, 15])).to_bytes(2, "big")
            data[at + 14] = 0x80 * rng.randint(2)
        if rng.rand() < 0.1:                # damaged: bits flipped
            for at in rng.randint(data.find(b"mdat") + 8, len(data),
                                  rng.randint(1, 4)):
                data[at] ^= 1 << rng.randint(8)
        _avif_against_cv2(tmp / f"{s:05d}.avif", bytes(data), split)
    print(f"{files} files")
    for k, v in sorted(split.items()):
        print(f"{k}: {v}")
    split = Counter()
    for s in range(files // 5):
        _avif_superres(s, tmp / f"superres_{s:05d}.avif", split)
    print(f"{files // 5} superres files (libaom 3.6 through ctypes)")
    for k, v in sorted(split.items()):
        print(f"{k}: {v}")


def _avif_against_cv2(path: Path, data: bytes, split: Counter) -> None:
    import cv2
    path.write_bytes(data)
    ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
    try:
        got, why = native.decode_image(str(path)), ""
    except native.ImageError as e:
        got, why = None, str(e).split(": ", 2)[-1]
    if ref is None:
        split["cv2 refuses, " + ("the port too" if got is None
                                 else "the port reads")] += 1
    elif got is None:
        split[f"the port refuses, cv2 reads: {why}"] += 1
    elif np.array_equal(got, ref[..., ::-1]):
        split["as cv2"] += 1
    else:
        split["both read, pixels differ"] += 1


def _avif_superres(s: int, path: Path, split: Counter) -> None:
    from objectdetectionpl_tpu_torch.tools.format_files import (
        aom_encode, av1c_bytes, avif_bytes)
    rng = np.random.RandomState(10_000 + s)
    h, w = rng.randint(16, 129), rng.randint(16, 321)
    sub = rng.choice(["4:2:0", "4:2:2", "4:4:4", "4:0:0"])
    denom = int(rng.randint(9, 17))
    y, x = np.mgrid[0:h, 0:w]
    noise = rng.randint(0, rng.choice([20, 80, 256]), (h, w))
    planes = [((x * 3 + y * 2) % 256 + noise).clip(0, 255).astype(np.uint8)]
    if sub != "4:0:0":
        sx, sy = int(sub != "4:4:4"), int(sub == "4:2:0")
        planes += [rng.randint(60, 200, ((h + sy) >> sy, (w + sx) >> sx))
                   .astype(np.uint8) for _ in range(2)]
    options = {"cq-level": int(rng.randint(5, 60)),
               "cpu-used": int(rng.randint(1, 7)),
               "enable-restoration": int(rng.randint(2)),
               "sb-size": str(rng.choice(["64", "128"]))}
    # libaom asks an inner tile column of 128 coded pixels under superres
    if (w * 8 + denom // 2) // denom > 136 and rng.rand() < 0.5:
        options["tile-columns"] = 1
    if rng.rand() < 0.25:
        options["film-grain-test"] = int(rng.randint(1, 17))
    data = bytearray(avif_bytes(aom_encode(planes, sub, superres=denom,
                                           options=options),
                                w, h, av1c_bytes(sub)))
    if rng.rand() < 0.1:
        for at in rng.randint(data.find(b"mdat") + 8, len(data),
                              rng.randint(1, 4)):
            data[at] ^= 1 << rng.randint(8)
    _avif_against_cv2(path, bytes(data), split)


def _probe_counts(title: str, split: Counter) -> None:
    print(title)
    for k, v in sorted(split.items()):
        print(f"{k}: {v}")


def _flip(rng, data: bytearray) -> None:
    for at in rng.randint(data.find(b"mdat") + 8, len(data),
                          rng.randint(1, 4)):
        data[at] ^= 1 << rng.randint(8)


# the colr boxes drawn: (primaries, matrix, full range)
_NCLX = [(1, 6, 1), (1, 1, 0), (1, 1, 1), (9, 9, 0), (1, 5, 0), (9, 12, 1),
         (4, 12, 0), (1, 0, 1), (1, 0, 0), (1, 4, 0), (1, 7, 1), (1, 8, 1),
         (1, 15, 0), (1, 2, 1), (1, 3, 0)]


def _depth_planes(rng, h: int, w: int, sub: str, depth: int):
    """Planes at ``depth``: smooth, noise, blocks or glyphs."""
    from objectdetectionpl_tpu_torch.tools.format_files import (
        _yuv, screen_regions, screen_text)
    top = (1 << depth) - 1
    kind = rng.choice(["smooth", "noise", "blocks", "text"])
    if kind in ("blocks", "text"):
        img = (screen_regions if kind == "blocks" else screen_text)(
            max(h, 12), max(w, 9), int(rng.randint(1 << 30)))[:h, :w]
        planes = _yuv(img, "4:2:0" if sub == "4:0:0" else sub)
        # 8-bit levels to the depth with their high bits replicated
        planes = [(p.astype(np.uint16) << (depth - 8))
                  | (p.astype(np.uint16) >> (16 - depth)) for p in planes]
    else:
        y, x = np.mgrid[0:h, 0:w]
        amp = top if kind == "noise" else top // 8
        luma = ((x * 3 + y * 2) * (top + 1) // 256 + rng.randint(
            0, amp + 1, (h, w))) % (top + 1)
        sx, sy = int(sub != "4:4:4"), int(sub in ("4:2:0", "4:0:0"))
        planes = [luma] + [rng.randint(0, top + 1, ((h + sy) >> sy,
                                                    (w + sx) >> sx))
                           for _ in range(2)]
    planes = [p.astype(np.uint16) for p in planes]
    return planes[:1] if sub == "4:0:0" else planes


def avif_depth(files: int) -> None:
    from objectdetectionpl_tpu_torch.tools.format_files import (
        aom_encode, av1c_bytes, avif_bytes)
    tmp = Path(tempfile.mkdtemp(prefix="probe_avif_depth_"))
    split = Counter()
    for s in range(files):
        rng = np.random.RandomState(20_000 + s)
        depth = int(rng.choice([10, 12]))
        sub = str(rng.choice(["4:2:0", "4:2:2", "4:4:4", "4:0:0"]))
        h, w = rng.randint(1, 201), rng.randint(1, 201)
        options = {"cq-level": int(rng.randint(0, 64)),
                   "cpu-used": int(rng.randint(1, 7)),
                   "enable-restoration": int(rng.randint(2)),
                   "sb-size": str(rng.choice(["64", "128"])),
                   "enable-qm": int(rng.randint(2)),
                   "deltaq-mode": int(rng.randint(2))}
        if rng.rand() < 1 / 3:
            options.update({"tune-content": "screen", "enable-palette": 1,
                            "enable-intrabc": int(rng.randint(2))})
        if rng.rand() < 0.2:
            options["film-grain-test"] = int(rng.randint(1, 17))
        if rng.rand() < 0.05:
            options["lossless"] = 1
        denom = None
        if rng.rand() < 0.2 and w >= 16:
            denom = int(rng.randint(9, 17))
            if (w * 8 + denom // 2) // denom > 136 and rng.rand() < 0.5:
                options["tile-columns"] = 1
        elif w > 64 and rng.rand() < 0.2:
            options["tile-columns"] = 1
        planes = _depth_planes(rng, h, w, sub, depth)
        try:
            obus = aom_encode(planes, sub, superres=denom, options=options,
                              bit_depth=depth)
        except RuntimeError:
            split["libaom refuses the options"] += 1
            continue
        primaries, matrix, full = _NCLX[rng.randint(len(_NCLX))]
        data = bytearray(avif_bytes(
            obus, w, h, av1c_bytes(sub, depth),
            nclx=(primaries, 13, matrix, full),
            pixi=(depth,) * (1 if sub == "4:0:0" else 3)))
        if rng.rand() < 0.1:
            _flip(rng, data)
        _avif_against_cv2(tmp / f"{s:05d}.avif", bytes(data), split)
    _probe_counts(f"{files} 10- and 12-bit files (libaom 3.6 through "
                  f"ctypes)", split)


def _pillow_sequence(rng) -> bytearray:
    import io
    from PIL import Image
    h, w = rng.randint(1, 121), rng.randint(1, 161)
    mode = str(rng.choice(["RGB", "RGBA"]))
    y, x = np.mgrid[0:h, 0:w]
    frames = []
    for k in range(rng.randint(2, 6)):
        img = np.stack([x * 3 + 40 * k, y * 4, (x + y) * 2], -1) + \
            rng.randint(0, 30, (h, w, 3))
        if mode == "RGBA":
            img = np.dstack([img, (x * 5 + y + 60 * k) % 256])
        frames.append(Image.fromarray(np.clip(img, 0, 255).astype(np.uint8),
                                      mode))
    out = io.BytesIO()
    frames[0].save(out, format="AVIF", save_all=True,
                   append_images=frames[1:], duration=100,
                   quality=int(rng.choice([30, 60, 90])),
                   speed=int(rng.choice([6, 8, 10])),
                   subsampling=str(rng.choice(["4:2:0", "4:4:4"])))
    data = bytearray(out.getvalue())
    if rng.rand() < 1 / 3 and data.count(b"stco") == 1 and \
            data.count(b"iloc") == 1:
        # the meta item at the second sample: cv2 reads the track
        stco, stsz = data.index(b"stco") + 12, data.index(b"stsz") + 16
        first = struct.unpack(">I", data[stco:stco + 4])[0]
        size = struct.unpack(">I", data[stsz:stsz + 4])[0]
        at = data.find(struct.pack(">I", first), data.index(b"iloc"))
        data[at:at + 4] = struct.pack(">I", first + size)
    return data


def _alpha_file(rng) -> bytearray:
    from objectdetectionpl_tpu_torch.tools.format_files import (
        aom_encode, av1c_bytes, avif_bytes)
    h, w = rng.randint(1, 121), rng.randint(1, 161)
    depth = int(rng.choice([8, 10, 12]))
    sub = str(rng.choice(["4:2:0", "4:2:2", "4:4:4"]))
    planes = _depth_planes(rng, h, w, sub, max(depth, 10))
    if depth == 8:
        planes = [p >> 2 for p in planes]
    obus = aom_encode(planes, sub, bit_depth=depth, options={
        "cq-level": int(rng.randint(5, 50)), "cpu-used": 5})
    a_depth = depth if rng.rand() < 0.9 else int(rng.choice([8, 10, 12]))
    ah, aw = (h, w) if rng.rand() < 0.9 else (h + 8, w)
    y, x = np.mgrid[0:ah, 0:aw]
    top = (1 << a_depth) - 1
    alpha = np.clip((x * 7 + y * 3) * (top + 1) // 256 % (top + 1)
                    + rng.randint(-top // 16, top // 16 + 1, (ah, aw)),
                    0, top)
    alpha[:2, :2], alpha[-2:, -2:] = 0, top
    a_obus = aom_encode([alpha.astype(np.uint16)], "4:0:0",
                        bit_depth=a_depth, options={
                            "cq-level": int(rng.randint(0, 30)),
                            "cpu-used": 5})
    primaries, matrix, full = _NCLX[rng.randint(len(_NCLX))]
    prem = ((b"prem", 1, 2),) if rng.rand() < 0.5 else ()
    return bytearray(avif_bytes(
        obus, w, h, av1c_bytes(sub, depth), nclx=(primaries, 13, matrix, full),
        pixi=(depth,) * 3, alpha=(a_obus, av1c_bytes("4:0:0", a_depth)),
        iref_extra=prem))


def avif_sequence(files: int) -> None:
    tmp = Path(tempfile.mkdtemp(prefix="probe_avif_sequence_"))
    for name, make in (("Pillow sequences", _pillow_sequence),
                       ("files with an alpha item (libaom 3.6)",
                        _alpha_file)):
        split = Counter()
        for s in range(files):
            rng = np.random.RandomState(30_000 + s)
            try:
                data = make(rng)
            except (OSError, ValueError, RuntimeError):
                split["the encoder refuses the options"] += 1
                continue
            if rng.rand() < 0.1:
                _flip(rng, data)
            _avif_against_cv2(tmp / f"{s:05d}.avif", bytes(data), split)
        _probe_counts(f"{files} {name}", split)


def _in_child(make) -> bytes:
    """``make()``'s bytes, run in a forked child; b"" where it fails or
    the child dies."""
    rfd, wfd = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(rfd)
        try:
            out = make()
        except Exception:
            out = b""
        os.write(wfd, out)
        os._exit(0)
    os.close(wfd)
    chunks = []
    while True:
        chunk = os.read(rfd, 1 << 16)
        if not chunk:
            break
        chunks.append(chunk)
    os.close(rfd)
    _, status = os.waitpid(pid, 0)
    return b"".join(chunks) if status == 0 else b""


def avif_layers(files: int) -> None:
    from objectdetectionpl_tpu_torch.tools.format_files import (
        BASE, TESTDATA, _yuv, aom_encode, av1c_bytes, avif_bytes, deepen,
        heif_box)
    rgb = native.decode_one(str(TESTDATA / BASE))
    tmp = Path(tempfile.mkdtemp(prefix="probe_avif_layers_"))
    split = Counter()
    for s in range(files):
        rng = np.random.RandomState(30_000 + s)
        h, w = rng.randint(32, 201), rng.randint(32, 201)
        y0, x0 = rng.randint(0, 376 - h), rng.randint(0, 501 - w)
        sub = str(rng.choice(["4:2:0", "4:2:0", "4:4:4", "4:2:2", "4:0:0"]))
        depth = int(rng.choice([8, 8, 10, 12]))
        usage, n = int(rng.randint(2)), int(rng.randint(2, 4))
        planes = _yuv(rgb[y0:y0 + h, x0:x0 + w],
                      "4:2:0" if sub == "4:0:0" else sub)
        planes = planes[:1] if sub == "4:0:0" else planes
        if depth > 8:
            planes = deepen(planes, depth)
        layers = []
        for k in range(n):
            lay = {"planes": planes}
            if rng.rand() < 0.7:
                lay["cq_level"] = int(rng.randint(5, 60))
            if k < n - 1 and rng.rand() < 0.4:
                m = int(rng.choice([1, 2, 3, 4, 6]))
                lay["scale"] = (m, m)
            layers.append(lay)
        options = {"cpu-used": int(rng.randint(0, 7) if usage == 0
                                   else rng.randint(5, 10))}
        obus = _in_child(lambda: aom_encode(None, sub, usage=usage,
                                            layers=layers, options=options,
                                            bit_depth=depth))
        if not obus:
            split["libaom's encoder fails"] += 1
            continue
        props = ()
        if rng.rand() < 0.2:
            props = ((heif_box(b"lsel", struct.pack(">H", rng.randint(n))),
                      True),)
        data = bytearray(avif_bytes(
            obus, w, h, av1c_bytes(sub, depth),
            pixi=(depth,) * (1 if sub == "4:0:0" else 3), extra_props=props))
        if rng.rand() < 0.1:
            _flip(rng, data)
        _avif_against_cv2(tmp / f"{s:05d}.avif", bytes(data), split)
    _probe_counts(f"{files} layered files (libaom 3.6's spatial layers "
                  f"through ctypes)", split)


def _inter_scaled(rng, rgb) -> bytes:
    from objectdetectionpl_tpu_torch.tools.format_files import (
        aom_encode, av1c_bytes, avif_bytes, deepen, moving_frames)
    h, w = rng.randint(32, 161), rng.randint(32, 161)
    n, sub = rng.randint(2, 7), str(rng.choice(["4:2:0", "4:4:4", "4:2:2"]))
    depth = int(rng.choice([8, 8, 10, 12]))
    dy, dx = rng.randint(-4, 5), rng.randint(-4, 5)
    y0 = rng.randint(max(0, -dy * n), 375 - h - max(0, dy * n))
    x0 = rng.randint(max(0, -dx * n), 500 - w - max(0, dx * n))
    fr = moving_frames(rgb, n, y0, x0, h, w, dy, dx, sub)
    if depth > 8:
        fr = [deepen(f, depth) for f in fr]
    options = {"cpu-used": int(rng.randint(0, 6)),
               "cq-level": int(rng.randint(5, 55))}
    for tool in ("enable-masked-comp", "enable-dist-wtd-comp", "enable-obmc",
                 "enable-interintra-comp", "enable-ref-frame-mvs",
                 "enable-dual-filter"):
        options[tool] = int(rng.randint(2))
    kw = {"lag": int(rng.randint(0, 7)), "bit_depth": depth,
          "options": options}
    if rng.rand() < 0.5:
        kw["resize"] = (1, int(rng.randint(9, 17)))
    else:
        kw["superres"] = int(rng.randint(9, 17))
    obus = _in_child(lambda: aom_encode(fr[0], sub, sequence=fr[1:], **kw))
    if not obus:
        return b""
    info = native.av1_probe(obus)
    return avif_bytes(obus, info["width"], info["height"],
                      av1c_bytes(sub, depth), pixi=(depth,) * 3)


def _inter_global(rng, rgb) -> bytes:
    from objectdetectionpl_tpu_torch.tools.format_files import (
        GM_ROTZOOM, aom_encode, av1c_bytes, avif_bytes, deepen,
        mosaic_frames, moving_frames, with_global_motion)
    sub = str(rng.choice(["4:2:0", "4:2:0", "4:4:4"]))
    depth = int(rng.choice([8, 8, 10]))
    h, w = 16 * rng.randint(3, 7), 16 * rng.randint(3, 9)
    n = rng.randint(3, 6)
    if rng.rand() < 0.7:
        fr = mosaic_frames(rgb, n, h, w, int(rng.randint(1 << 16)), sub=sub)
    else:
        fr = moving_frames(rgb, n, 100, 150, h, w, rng.randint(-3, 4),
                           rng.randint(-3, 4), sub)
    if depth > 8:
        fr = [deepen(f, depth) for f in fr]
    usage = int(rng.randint(2))
    options = {"cpu-used": int(rng.randint(6, 10) if usage
                               else rng.randint(0, 6)),
               "cq-level": int(rng.randint(10, 50))}
    if rng.rand() < 0.7:
        options.update({"enable-obmc": 0, "enable-warped-motion": 0})
    obus = _in_child(lambda: aom_encode(
        fr[0], sub, sequence=fr[1:], usage=usage, bit_depth=depth,
        lag=0 if usage else int(rng.randint(0, 4)), options=options))
    if not obus:
        return b""
    one = 1 << 16
    models = {}
    for ref in ([1] if rng.rand() < 0.5 else range(1, 8)):
        kind = str(rng.choice(["identity", "translation", "rotzoom",
                               "affine"]))
        if kind == "rotzoom" and rng.rand() < 0.5:
            models[ref] = GM_ROTZOOM
            continue
        big = rng.rand() < 0.3            # shears past the warp's limit
        a = 1 << (12 if big else 7)
        mat = [int(rng.randint(-64, 65)) << 10, int(rng.randint(-64, 65))
               << 10] + [2 * int(rng.randint(-a, a + 1)) for _ in range(4)]
        mat[2] += one
        mat[5] += one
        if kind == "translation":
            mat = [int(rng.randint(-64, 65)) << 14,
                   int(rng.randint(-64, 65)) << 14, one, 0, 0, one]
        models[ref] = (kind, mat)
    inter = [m for m in native.av1_frame_marks(obus)
             if m["gm_start"] >= 0 and m["frame_type"] in (1, 3)]
    if not inter:
        return b""
    obus = with_global_motion(obus, models, int(rng.randint(len(inter))))
    return avif_bytes(obus, w, h, av1c_bytes(sub, depth), pixi=(depth,) * 3)


def _inter_lost(rng, rgb) -> bytes:
    from objectdetectionpl_tpu_torch.tools.format_files import (
        AOM_EFLAG_ERROR_RESILIENT, aom_encode, av1c_bytes, avif_bytes,
        deepen, moving_frames, temporal_units)
    sub = str(rng.choice(["4:2:0", "4:2:0", "4:4:4"]))
    depth = int(rng.choice([8, 8, 10]))
    h, w = rng.randint(32, 129), rng.randint(32, 161)
    n = rng.randint(3, 7)
    fr = moving_frames(rgb, n, 150, 200, h, w, rng.randint(-3, 4),
                       rng.randint(-3, 4), sub)
    if depth > 8:
        fr = [deepen(f, depth) for f in fr]
    flags = [0] + [AOM_EFLAG_ERROR_RESILIENT * int(rng.rand() < 0.4)
                   for _ in range(n - 1)]
    flags[-1] = AOM_EFLAG_ERROR_RESILIENT
    if rng.rand() < 0.3:      # the last frame refers to the ALTREF slot alone
        flags[-1] |= sum(1 << b for b in (16, 17, 18, 19, 21, 22))
    obus = _in_child(lambda: aom_encode(
        fr[0], sub, sequence=fr[1:], bit_depth=depth, flags=flags,
        lag=int(rng.randint(0, 4)), options={
            "cpu-used": int(rng.randint(1, 7)),
            "cq-level": int(rng.randint(10, 50))}))
    if not obus:
        return b""
    units = temporal_units(obus)
    if len(units) < 3:
        return b""
    drop = int(rng.randint(1, len(units) - 1))
    obus = b"".join(u for i, u in enumerate(units) if i != drop)
    return avif_bytes(obus, w, h, av1c_bytes(sub, depth), pixi=(depth,) * 3)


def _inter_alpha_grid(rng, rgb) -> bytes:
    from objectdetectionpl_tpu_torch.tools.format_files import (
        _yuv, aom_encode, av1c_bytes, avif_grid_bytes, deepen)
    rows, cols = rng.randint(1, 3), rng.randint(1, 4)
    th, tw = 2 * rng.randint(32, 41), 2 * rng.randint(32, 41)
    sub = str(rng.choice(["4:2:0", "4:4:4", "4:2:2"]))
    depth = int(rng.choice([8, 10, 12]))

    def encode():
        tiles, alphas = [], []
        for i in range(rows * cols):
            y0, x0 = rng.randint(0, 375 - th), rng.randint(0, 500 - tw)
            planes = _yuv(rgb[y0:y0 + th, x0:x0 + tw], sub)
            if depth > 8:
                planes = deepen(planes, depth)
            tiles.append(aom_encode(planes, sub, bit_depth=depth, options={
                "cq-level": int(rng.randint(10, 50)), "cpu-used": 5}))
            a_depth = depth if rng.rand() < 0.95 else int(rng.choice(
                [d for d in (8, 10, 12) if d != depth]))
            top = (1 << a_depth) - 1
            y, x = np.mgrid[0:th, 0:tw]
            alpha = ((x * rng.randint(1, 9) + y * rng.randint(1, 9)) * (
                top + 1) // 256 + rng.randint(top + 1)) % (top + 1)
            alphas.append((aom_encode([alpha.astype(np.uint16)], "4:0:0",
                                      bit_depth=a_depth, options={
                                          "cq-level": int(rng.randint(0, 30)),
                                          "cpu-used": 5}),
                           av1c_bytes("4:0:0", a_depth)))
        return tiles, alphas

    tiles, alphas = encode()
    n = rows * cols
    refs = [(b"prem", n + 1, 2 * n + 2)] if rng.rand() < 0.5 else []
    if rng.rand() < 0.1:          # a tile without alpha
        alphas = alphas[:-1]
    if rng.rand() < 0.05:         # a second alpha item for the first tile
        refs.append((b"auxl", n + 1 + len(alphas), 1))
    out_w = tw * cols - (rng.randint(0, tw // 2) if rng.rand() < 0.3 else 0)
    out_h = th * rows - (rng.randint(0, th // 2) if rng.rand() < 0.3 else 0)
    if sub != "4:4:4":
        out_w -= out_w % 2
    if sub == "4:2:0":
        out_h -= out_h % 2
    return avif_grid_bytes(tiles, tw, th, av1c_bytes(sub, depth), rows, cols,
                           output=(out_w, out_h), depth=depth, alpha=alphas,
                           iref_extra=refs)


def avif_inter(files: int) -> None:
    from objectdetectionpl_tpu_torch.tools.format_files import BASE, TESTDATA
    rgb = native.decode_one(str(TESTDATA / BASE))
    tmp = Path(tempfile.mkdtemp(prefix="probe_avif_inter_"))
    for name, make in (("compound from a scaled reference", _inter_scaled),
                       ("global motion rewritten", _inter_global),
                       ("a temporal unit lost", _inter_lost),
                       ("alpha on a grid's tiles", _inter_alpha_grid)):
        split = Counter()
        for s in range(files // 4):
            rng = np.random.RandomState(40_000 + s)
            try:
                data = bytearray(make(rng, rgb))
            except (RuntimeError, ValueError):
                data = bytearray()
            if not data:
                split["libaom's encoder fails"] += 1
                continue
            if rng.rand() < 0.1:
                _flip(rng, data)
            _avif_against_cv2(tmp / f"{s:05d}.avif", bytes(data), split)
        _probe_counts(f"{files // 4} files, {name} (libaom 3.6 through "
                      f"ctypes)", split)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probe", choices=["fax", "gif", "avif", "avif_depth",
                                      "avif_sequence", "avif_layers",
                                      "avif_inter"])
    ap.add_argument("--seeds", type=int, default=60)
    ap.add_argument("--files", type=int, default=None)
    a = ap.parse_args()
    if a.probe == "fax":
        fax(a.seeds)
    elif a.probe == "gif":
        gif(a.files or 3000)
    elif a.probe == "avif":
        avif(a.files or 400)
    elif a.probe == "avif_depth":
        avif_depth(a.files or 400)
    elif a.probe == "avif_layers":
        avif_layers(a.files or 400)
    elif a.probe == "avif_inter":
        avif_inter(a.files or 400)
    else:
        avif_sequence(a.files or 400)


if __name__ == "__main__":
    main()
