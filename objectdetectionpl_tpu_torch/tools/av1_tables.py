"""Write ``csrc/av1_tables.h``: the AV1 decoder's default CDFs (intra
modes, coefficients, palettes, intra block copy's vectors and inter
transforms), its quantizer lookups at 8, 10 and 12 bits, the intra
tables the specification lists by value and those of loop restoration,
superres and film grain, read from the read-only data of libaom 3.6 (``libaom.so.3``, found in the
dynamic linker's cache unless ``--lib`` names it).

    python -m objectdetectionpl_tpu_torch.tools.av1_tables [--lib P] [--check]

Each table is found by its leading values (unique in the library's
``.rodata``; five in ``.text``, where the compiler made them immediates)
and read at the dimensions the specification gives.  libaom keeps a CDF
of N symbols as N - 1 values ``32768 - x`` falling strictly to 0, then 0
for the 32768 the specification writes, then a 0 counter, padded with
zeros to its array's row; every row is held to that before it is turned
into the specification's rising form ``x_1 .. x_(N-1), 32768, 0``.
What the specification defines by formula (the cosine and sine
constants) is checked against the library's own copy.

The header is committed: the build reads it and no system library.
``--check`` compares the committed header with what the library gives
and exits 1 where they differ.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np

HEADER = (Path(__file__).resolve().parents[1] / "csrc" / "av1_tables.h")

# (name in the header, leading values in the specification's form, the
# array's dimensions (the last one the stored row width), symbols per
# row: an int, or a function of the row's index tuple[, how many leading
# values come before the table[, how the library stores it]]).  The
# compiler copies small tables with 16-byte moves from a constant pool
# and stores what is left over as immediates in its code, so some rows
# are in the data only in part: ("rows", stride, n) each row's first n
# values, ``stride`` apart; ("chunks", ((i, n, j), ...)) the table's
# values i .. i + n - 1 at the data's j .. j + n - 1 (a 16-byte tail is
# copied from where it overlaps the chunk before it).  What is in no
# chunk must be a row's trailing zeros.  Leading values are a table's first
# row, or its first rows where one row is not unique.  The intra tx-type
# CDFs are sets 1 and 2 of libaom's [3][4][13][17] (set 0, DCT only,
# holds none).
_PART = {0: 4, 1: 10, 2: 10, 3: 10, 4: 8}
CDFS = (
    ("Default_Intra_Frame_Y_Mode_Cdf", (15588, 17027, 19338, 20218),
     (5, 5, 14), 13),
    ("Default_Uv_Mode_Cdf", (22631, 24152, 25378, 25661),
     (2, 13, 15), lambda i: 13 + i[0]),
    ("Default_Angle_Delta_Cdf", (2180, 5032, 7567, 22776),
     (8, 8), 7),
    ("Default_Partition_Cdf", (19132, 25510, 30392),
     (20, 11), lambda i: _PART[i[0] // 4]),
    ("Default_Skip_Cdf", (31671, 0, 0, 16515), (3, 3), 2, 0,
     ("chunks", ((0, 8, 0),))),
    ("Default_Segment_Id_Cdf", (5622, 7893, 16093, 18233),
     (3, 9), 8, 0, ("rows", 8, 8)),
    # delta_q's, delta_lf's and delta_lf_multi's rows are equal, and the
    # compiler keeps them as overlapping copies: the first is read
    ("Default_Delta_Q_Cdf", (16803, 22759, 0, 0, 28160, 32120, 32677),
     (5,), 4, 4),
    ("Default_Filter_Intra_Cdfs", (4621, 0, 0, 6743, 0, 0), (10, 3), 2),
    ("Default_Filter_Intra_Cdfs_Wide", (12770, 0, 0, 10368, 0, 0),
     (4, 3), 2),
    ("Default_Tx_Size_Cdf", (19968, 0, 0, 0, 19968), (4, 3, 4),
     lambda i: 2 if i[0] == 0 else 3),
    ("Default_Intra_Tx_Type_Cdf", (1535, 8035, 9461, 12751),
     (2, 4, 13, 17), lambda i: 7 if i[0] == 0 else 5),
    ("Default_Palette_Y_Mode_Cdf", (31676, 0, 0, 3419, 0, 0), (7, 3, 3), 2,
     0, ("chunks", ((0, 56, 0), (55, 8, 56)))),
    ("Default_Cfl_Sign_Cdf", (1418, 2123, 13340, 18405), (9,), 8, 0,
     ("chunks", ((0, 8, 0),))),
    ("Default_Cfl_Alpha_Cdf", (7637, 20719, 31401, 32481), (6, 17), 16,
     0, ("chunks", ((0, 96, 0), (94, 8, 96)))),
    ("Default_Txb_Skip_Cdf", (31849, 0, 0, 5892), (4, 5, 13, 3), 2),
    ("Default_Eob_Pt_16_Cdf", (840, 1039, 1980, 4895), (4, 2, 2, 6), 5),
    ("Default_Eob_Pt_32_Cdf", (400, 520, 977, 2102, 6542), (4, 2, 2, 7), 6),
    ("Default_Eob_Pt_64_Cdf", (329, 498, 1101, 1784, 3265, 7758),
     (4, 2, 2, 8), 7),
    ("Default_Eob_Pt_128_Cdf", (219, 482, 1140, 2091, 3680, 6028),
     (4, 2, 2, 9), 8),
    ("Default_Eob_Pt_256_Cdf", (310, 584, 1887, 3589, 6168, 8611),
     (4, 2, 2, 10), 9),
    ("Default_Eob_Pt_512_Cdf", (641, 983, 3707, 5430, 10234, 14958),
     (4, 2, 2, 11), 10),
    ("Default_Eob_Pt_1024_Cdf", (393, 421, 751, 1623, 3160, 6352),
     (4, 2, 2, 12), 11),
    ("Default_Eob_Extra_Cdf", (16961, 0, 0, 17223), (4, 5, 2, 9, 3), 2),
    ("Default_Dc_Sign_Cdf", (16000, 0, 0, 13056), (4, 2, 3, 3), 2),
    ("Default_Coeff_Base_Eob_Cdf", (17837, 29055, 0, 0, 29600),
     (4, 5, 2, 4, 4), 3),
    ("Default_Coeff_Base_Cdf", (4034, 8930, 12727, 0, 0, 18082),
     (4, 5, 2, 42, 5), 4),
    ("Default_Coeff_Br_Cdf", (14298, 20718, 24174, 0, 0, 12536),
     (4, 5, 2, 21, 5), 4),
    # palettes: the sizes by block size, the colour indices by palette
    # size (2..8 symbols) and colour context
    ("Default_Palette_Y_Size_Cdf", (7952, 13000, 18149, 21478), (7, 8), 7),
    ("Default_Palette_Uv_Size_Cdf", (8713, 19979, 27128, 29609), (7, 8), 7),
    ("Default_Palette_Y_Color_Cdf", (28710,) + (0,) * 8 + (16384,),
     (7, 5, 9), lambda i: i[0] + 2),
    ("Default_Palette_Uv_Color_Cdf", (29089,) + (0,) * 8 + (16384,),
     (7, 5, 9), lambda i: i[0] + 2),
    # intra block copy: the var-tx split flag, the inter tx-type CDFs (sets
    # 1, 2 and 3 of libaom's [4][4][17]; set 0, DCT only, holds none) and
    # the MV joint CDF, the first field of libaom's MV context
    ("Default_Txfm_Split_Cdf", (28581, 0, 0, 23846), (21, 3), 2, 0,
     ("chunks", ((0, 56, 0), (55, 8, 56)))),
    ("Default_Inter_Tx_Type_Cdf", (4458, 5560, 7695, 9709), (3, 4, 17),
     lambda i: (16, 12, 2)[i[0]]),
    ("Default_Mv_Joint_Cdf", (4096, 11264, 19328), (5,), 4),
)

# The MV context's per-component CDFs an integer vector reads, at their
# offsets (in values) from the joint CDF's start in libaom's
# nmv_context {joints, comps[2]}: a component is 69 values, and the two
# hold the same defaults (checked).
MV_COMP = 69
MV_CDFS = (("Default_Mv_Class_Cdf", 5, (12,), 11),
           ("Default_Mv_Sign_Cdf", 32, (3,), 2),
           ("Default_Mv_Class0_Bit_Cdf", 41, (3,), 2),
           ("Default_Mv_Bit_Cdf", 44, (10, 3), 2))

# libaom keeps these as immediates in its code, not as data: the
# filter-intra mode CDF is found there all the same (four values), and so
# are the loop restoration CDFs, three stores in a row (the Wiener and
# self-guided one-value rows are found in the 64 bytes after the
# switchable row: alone they are not unique); the palette UV flag's two
# one-value rows are the specification's.
TEXT_CDFS = (("Default_Filter_Intra_Mode_Cdf", (8949, 12776, 17211, 29558),
              (6,), 5),
             ("Default_Restoration_Type_Cdf", (9413, 22581), (4,), 3),
             ("Default_Use_Wiener_Cdf", (11570,), (3,), 2,
              "Default_Restoration_Type_Cdf"),
             ("Default_Use_Sgrproj_Cdf", (16855,), (3,), 2,
              "Default_Use_Wiener_Cdf"))
# so is the intra block copy flag's one value (an immediate found many
# times over)
SPEC_CDFS = (("Default_Palette_Uv_Mode_Cdf", ((32461,), (21488,)), 2),
             ("Default_Intrabc_Cdf", ((30531,),), 2))
# the palette colour context's neighbour weights (left, above-left,
# above) and hash multipliers are the specification's: libaom keeps them
# as int arrays of three small values, found many times over
SPEC_TABLES = (("Palette_Color_Weights", (2, 1, 2)),
               ("Palette_Color_Hash_Multipliers", (1, 2, 2)))

# other tables: (name, C type, leading values, numpy type, count or
# shape); a tuple of leading values for each row of a table whose rows
# libaom keeps apart (the quantizer lookups at 8, 10 and 12 bits)
PLAIN = (
    ("Dc_Qlookup", "int16_t", ((4, 8, 8, 9, 10, 11, 12, 12),
                               (4, 9, 10, 13, 15, 17, 20, 22),
                               (4, 12, 18, 25, 33, 41, 50, 60)),
     np.int16, (3, 256)),
    ("Ac_Qlookup", "int16_t", ((4, 8, 9, 10, 11, 12, 13, 14),
                               (4, 9, 11, 13, 16, 18, 21, 24),
                               (4, 13, 19, 27, 35, 44, 54, 64)),
     np.int16, (3, 256)),
    ("Filter_Intra_Taps", "int8_t", (-6, 10, 0, 0, 0, 12, 0, 0), np.int8,
     5 * 8 * 8),
    ("Dr_Intra_Derivative", "int16_t", (0, 0, 0, 1023, 0, 0, 547),
     np.int16, 90),
    # the smooth weights of sizes 4, 8, 16, 32 and 64: size n's at n - 4
    ("Sm_Weight_Arrays", "uint8_t", (255, 149, 85, 64, 255, 197, 146, 105),
     np.uint8, 124),
    ("Div_Table", "int32_t", (0, 840, 420, 280, 210, 168, 140, 120, 105),
     np.int32, 9),
    # the dequantizing weights of quantizer-matrix levels 0..14, luma and
    # chroma, the transform sizes one after another (libaom's layout)
    ("Quantizer_Matrix", "uint8_t", (32, 43, 73, 97, 43, 67, 94, 110),
     np.uint8, (15, 2, 3344)),
    # the self-guided filter's radii and scale factors s, libaom's
    # {r0, r1, s0, s1} a set (-1 where the radius is 0)
    ("Sgr_Params", "int16_t", (2, 1, 140, 3236, 2, 1, 112, 2158), np.int32,
     (16, 4)),
    # superres: 64 phases of 8 taps
    ("Upscale_Filter", "int16_t", (0, 0, 0, 128, 0, 0, 0, 0, 0, 0, -1, 128),
     np.int16, (64, 8)),
    ("Gaussian_Sequence", "int16_t", (56, 568, -180, 172, 124, -84, 172, -64),
     np.int32, 2048),
    # the palette colour context of each hash (-1 where none)
    ("Palette_Color_Context", "int8_t", (-1, -1, 0, -1, -1, 4, 3, 2, 1),
     np.int32, 9),
)

# The Wiener and self-guided coefficient limits are macros in libaom: its
# data holds them only as vector constants -- the default Wiener filter
# {3, -7, 15, 106, 15, -7, 3} (the middle values and 128 less twice their
# sum), taps 0 and 1's minima and maxima {-5, -23, 10, 8}, and the
# self-guided {min0, min1, max0, max1} -- each found by its values and
# held to the specification's tables; tap 2's limits and the subexp k are
# the specification's.
WIENER_MIN, WIENER_MAX, WIENER_K = (-5, -23, -17), (10, 8, 46), (1, 2, 3)
LIMITS = ("Wiener_Taps_Mid", "Wiener_Taps_Min", "Wiener_Taps_Max",
          "Wiener_Taps_K", "Sgrproj_Xqd_Mid", "Sgrproj_Xqd_Min",
          "Sgrproj_Xqd_Max")


class TableError(ValueError):
    pass


def _sections(lib: bytes):
    """(offset, size) of .rodata and .text from the ELF section headers."""
    shoff = int.from_bytes(lib[0x28:0x30], "little")
    shentsize = int.from_bytes(lib[0x3A:0x3C], "little")
    shnum = int.from_bytes(lib[0x3C:0x3E], "little")
    shstrndx = int.from_bytes(lib[0x3E:0x40], "little")

    def sh(i):
        at = shoff + i * shentsize
        name = int.from_bytes(lib[at:at + 4], "little")
        off = int.from_bytes(lib[at + 0x18:at + 0x20], "little")
        size = int.from_bytes(lib[at + 0x20:at + 0x28], "little")
        return name, off, size

    _, stroff, _ = sh(shstrndx)
    out = {}
    for i in range(shnum):
        name, off, size = sh(i)
        end = lib.index(b"\0", stroff + name)
        out[lib[stroff + name:end].decode()] = (off, size)
    return out


def _find_one(lib: bytes, section, pattern: bytes, what: str,
              span: int = 0) -> int:
    """The one place of ``pattern`` in the section (others allowed only
    inside the ``span`` bytes that follow it: a table whose rows
    repeat)."""
    off, size = section
    at = lib.find(pattern, off, off + size)
    if at < 0 or lib.find(pattern, at + max(span, 1), off + size) >= 0:
        raise TableError(f"{what}: its leading values are "
                         f"{'missing' if at < 0 else 'not unique'}")
    return at


def _icdf(vals) -> bytes:
    return np.array([32768 - v if v else 0 for v in vals],
                    np.uint16).tobytes()


def _stored(lib: bytes, at: int, dims, layout) -> np.ndarray:
    """The table as libaom's compiler left it in the data, zeros where
    it did not."""
    count = int(np.prod(dims))
    if layout is None:
        return np.frombuffer(lib, np.uint16, count, at).reshape(dims)
    flat = np.zeros(count, np.uint16)
    if layout[0] == "chunks":
        for i, n, j in layout[1]:
            flat[i:i + n] = np.frombuffer(lib, np.uint16, n, at + 2 * j)
    else:
        _, stride, n = layout
        for r in range(count // dims[-1]):
            flat[r * dims[-1]:r * dims[-1] + n] = np.frombuffer(
                lib, np.uint16, n, at + 2 * r * stride)
    return flat.reshape(dims)


def _rows(raw: np.ndarray, dims, nsym, name: str) -> np.ndarray:
    """libaom's rows -> the specification's rising rows, checked."""
    out = np.zeros(raw.shape, np.int64)
    for idx in np.ndindex(*dims[:-1]):
        n = nsym(idx) if callable(nsym) else nsym
        row = raw[idx].astype(np.int64)
        inv = row[:n - 1]
        if (not np.all((inv > 0) & (inv < 32768))
                or np.any(np.diff(inv) > 0) or np.any(row[n - 1:] != 0)):
            raise TableError(f"{name}{list(idx)}: {row.tolist()} is not a "
                             f"CDF of {n} symbols")
        out[idx][:n - 1] = 32768 - inv
        out[idx][n - 1] = 32768
    return out


def _whole(name: str, table: bytes) -> bool:
    """False for a partial copy of the smooth weights (the SIMD code
    keeps the small sizes alone): each size's run starts at 255 and
    falls."""
    if name != "Sm_Weight_Arrays":
        return True
    w = np.frombuffer(table, np.uint8).astype(int)
    return all(w[n - 4] == 255 and np.all(np.diff(w[n - 4:2 * n - 4]) <= 0)
               for n in (4, 8, 16, 32, 64))


def find_libaom() -> Optional[str]:
    """libaom.so.3's path from ``ldconfig -p``, or None."""
    try:
        out = subprocess.run(["ldconfig", "-p"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    for line in out.splitlines():
        if line.split(" ", 1)[0].strip() == "libaom.so.3" and "=>" in line:
            return line.split("=>", 1)[1].strip()
    return None


def read_tables(path: str) -> dict:
    """name -> numpy array, every table of the header."""
    lib = Path(path).read_bytes()
    sec = _sections(lib)
    ro, text = sec[".rodata"], sec[".text"]
    tables = {}
    for name, lead, dims, nsym, *rest in CDFS:
        before, layout = rest + [0, None][len(rest):]
        at = _find_one(lib, ro, _icdf(lead), name,
                       2 * int(np.prod(dims))) + 2 * before
        raw = _stored(lib, at, dims, layout)
        tables[name] = _rows(raw, dims, nsym, name)
    found = {}
    for name, lead, dims, nsym, *after in TEXT_CDFS:
        if after:
            start = found[after[0]]
            at = lib.find(_icdf(lead), start + 1, start + 64)
            if at < 0:
                raise TableError(f"{name}: not within 64 bytes of "
                                 f"{after[0]}")
        else:
            at = _find_one(lib, text, _icdf(lead), name)
        found[name] = at
        raw = np.zeros(dims, np.uint16)
        raw[:nsym - 1] = np.frombuffer(lib, np.uint16, nsym - 1, at)
        tables[name] = _rows(raw, dims, nsym, name)
    joint = _find_one(lib, ro, _icdf(CDFS[-1][1]), "Default_Mv_Joint_Cdf")
    for name, off, dims, nsym in MV_CDFS:
        comps = [_rows(_stored(lib, joint + 2 * (off + c * MV_COMP), dims,
                               None), dims, nsym, name) for c in (0, 1)]
        if not np.array_equal(*comps):
            raise TableError(f"{name}: the MV components differ")
        tables[name] = comps[0]
    for name, rows, n in SPEC_CDFS:
        t = np.zeros((len(rows), n + 1), np.int64)
        for i, r in enumerate(rows):
            t[i, :n - 1] = r
            t[i, n - 1] = 32768
        tables[name] = t
    for name, _, lead, dt, shape in PLAIN:
        rows = lead if isinstance(lead[0], tuple) else (lead,)
        size = int(np.prod(shape)) // len(rows) * np.dtype(dt).itemsize
        parts = []
        for row in rows:
            pattern = np.array(row, dt).tobytes()
            copies = set()  # the SIMD code keeps copies of some: all equal
            at = lib.find(pattern, ro[0], ro[0] + ro[1])
            while at >= 0:
                if _whole(name, lib[at:at + size]):
                    copies.add(lib[at:at + size])
                at = lib.find(pattern, at + 1, ro[0] + ro[1])
            if len(copies) != 1:
                raise TableError(f"{name}: {len(copies)} different tables")
            parts.append(copies.pop())
        tables[name] = np.frombuffer(b"".join(parts), dt).astype(
            np.int64).reshape(shape)
    for name, values in SPEC_TABLES:
        tables[name] = np.array(values)
    tables.update(_restoration_limits(lib, ro))
    # the formulas against the library's cospi / sinpi arrays (cos_bit 12)
    cos = [round(4096 * math.cos(i * math.pi / 128)) for i in range(64)]
    _find_one(lib, ro, np.array(cos, np.int32).tobytes(), "cospi")
    sinpi = [0] + [round(4096 * 2 * math.sqrt(2) / 3 * math.sin(
        i * math.pi / 9)) for i in range(1, 5)]
    _find_one(lib, ro, np.array(sinpi, np.int32).tobytes(), "sinpi")
    return tables


def _restoration_limits(lib: bytes, ro) -> dict:
    """LIMITS from the library's vector constants (see WIENER_MIN)."""
    def row(lead, n):
        at = _find_one(lib, ro, np.array(lead, np.int32).tobytes(), str(lead))
        return np.frombuffer(lib, np.int32, n, at).astype(np.int64)

    wiener = row((3, -7, 15, 106), 8)
    if wiener[3] != 128 - 2 * wiener[:3].sum() or any(
            wiener[4:7] != wiener[2::-1]):
        raise TableError(f"the default Wiener filter {wiener.tolist()}")
    if row((-5, -23, 10, 8), 4).tolist() != [*WIENER_MIN[:2],
                                             *WIENER_MAX[:2]]:
        raise TableError("the Wiener taps' limits differ")
    sgr = row((-96, -32, 31, 95), 4)
    lo, hi = sgr[:2], sgr[2:]
    return {"Wiener_Taps_Mid": wiener[:3],
            "Wiener_Taps_Min": np.array(WIENER_MIN),
            "Wiener_Taps_Max": np.array(WIENER_MAX),
            "Wiener_Taps_K": np.array(WIENER_K),
            # set_default_sgrproj: (min + max) / 2, truncated
            "Sgrproj_Xqd_Mid": np.trunc((lo + hi) / 2).astype(np.int64),
            "Sgrproj_Xqd_Min": lo, "Sgrproj_Xqd_Max": hi}


def _c_array(name: str, ctype: str, a: np.ndarray) -> str:
    dims = "".join(f"[{d}]" for d in a.shape)

    def body(x, depth):
        if x.ndim == 1:
            return "{" + ", ".join(str(int(v)) for v in x) + "}"
        pad = "\n" + "  " * (depth + 1)
        return ("{" + pad + ("," + pad).join(body(y, depth + 1) for y in x)
                + "}")

    return f"static const {ctype} {name}{dims} = {body(a, 0)};\n"


def render(tables: dict) -> str:
    lines = ["// Generated by objectdetectionpl_tpu_torch/tools/av1_tables.py "
             "from libaom 3.6's\n// read-only data; do not edit.  CDFs in "
             "the AV1 specification's rising form:\n// a row of N symbols "
             "holds x_1 .. x_(N-1), 32768, then a 0 counter.\n",
             "#pragma once\n#include <stdint.h>\n"]
    for name, *_ in CDFS + TEXT_CDFS + MV_CDFS:
        lines.append(_c_array(name, "uint16_t", tables[name]))
    for name, *_ in SPEC_CDFS:
        lines.append(_c_array(name, "uint16_t", tables[name]))
    for name, ctype, *_ in PLAIN:
        lines.append(_c_array(name, ctype, tables[name]))
    for name in LIMITS:
        lines.append(_c_array(name, "int8_t", tables[name]))
    for name, _ in SPEC_TABLES:
        lines.append(_c_array(name, "int8_t", tables[name]))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lib", default=None,
                    help="libaom.so.3 (default: from ldconfig -p)")
    ap.add_argument("--check", action="store_true",
                    help="compare with the committed header, write nothing")
    args = ap.parse_args(argv)
    lib = args.lib or find_libaom()
    if lib is None:
        print("libaom.so.3 is not in the dynamic linker's cache: give --lib")
        return 2
    text = render(read_tables(lib))
    if args.check:
        same = HEADER.read_text() == text
        print("the header matches" if same else "the header differs")
        return 0 if same else 1
    HEADER.write_text(text)
    print(f"wrote {HEADER}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
