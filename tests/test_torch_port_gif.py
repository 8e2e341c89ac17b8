"""GIF files through the port's reader (``csrc/gif_decode.cc`` and
``data/formats.py::read_gif``) against the JAX package's ``load_image_rgb``
(``cv2.imread``: cv2 5's own GifDecoder, the first frame), bit for bit,
under a .gif and a .jpg name.

- Pillow's GIF writer and the writers of ``tools/format_files.py``
  (``gif_bytes``, ``gif_image``, ``gif_lzw``): GIF87a and GIF89a, global
  and local colour tables of 2 to 256 entries, minimum code sizes 2 to 8,
  interlaced rows at every height class, a full 4096-entry table with a
  Clear and with a deferred clear, frames smaller than the screen at an
  offset, the transparency index of a graphic control extension under
  each disposal, with and without a global table, indices past the local
  table, no colour table at all, comment, application, plain-text and
  unknown extensions, further frames;
- hand-made LZW code streams: the End code missing (the padding bits
  decode), frames short of pixels, a first code that is not a colour, a
  code past the table, codes past the frame and after the End code;
- files cv2 refuses: ``GIF89a`` and zeros, a bad signature, a screen of
  0x0, a background index past the table, a frame outside the screen, no
  image, a graphic control extension of the wrong size, stray bytes
  between blocks, files cut short.
"""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from objectdetectionpl_tpu.data.parsers.common import load_image_rgb
from objectdetectionpl_tpu_torch.data import formats, native
from objectdetectionpl_tpu_torch.data.parsers import common
from objectdetectionpl_tpu_torch.tools.format_files import (gif_blocks,
                                                            gif_bytes,
                                                            gif_image)


def like_cv2(tmp_path, data: bytes, name="img"):
    """The port reads ``data`` as cv2 does under .gif and .jpg names;
    returns cv2's image, or None when both refuse it."""
    out = None
    for ext in (".gif", ".jpg"):
        path = tmp_path / f"{name}{ext}"
        path.write_bytes(data)
        if cv2.imread(str(path)) is None:
            for fn in (native.decode_image, common.load_image_rgb):
                with pytest.raises(native.ImageError,
                                   match=f"^{path}: GIF: "):
                    fn(str(path))
            continue
        ref = load_image_rgb(str(path))
        for fn in (native.decode_image, common.load_image_rgb):
            got = fn(str(path))
            assert got.dtype == np.uint8 and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref, err_msg=str(path))
        out = ref
    return out


def palette(rng, n):
    return rng.randint(0, 256, (n, 3))


def pack(codes) -> bytes:
    """(code, width) pairs -> LSB-first bytes."""
    acc = nbits = 0
    out = bytearray()
    for code, width in codes:
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc)
    return bytes(out)


def widths(codes, mcs=2):
    """Each code with the width a decoder reads it at (an End code resets
    it as a Clear does)."""
    clear, end = 1 << mcs, (1 << mcs) + 1
    nxt, width, first, out = end + 1, mcs + 1, True, []
    for c in codes:
        out.append((c, width))
        if c in (clear, end):
            nxt, width, first = end + 1, mcs + 1, True
        elif c != end:
            if not first and nxt < 4096:
                nxt += 1
            first = False
            if nxt == 1 << width and width < 12:
                width += 1
    return out


def raw_frame(w, h, codes, mcs=2) -> bytes:
    return (b"," + struct.pack("<HHHHB", 0, 0, w, h, 0) + bytes([mcs])
            + gif_blocks(pack(widths(codes, mcs))))


def test_pillow(tmp_path):
    rng = np.random.RandomState(0)
    for shape in ((1, 1), (7, 5), (33, 17), (64, 64)):
        img = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
        for kw in ({}, {"interlace": False}, {"optimize": False}):
            bio = io.BytesIO()
            Image.fromarray(img).save(bio, "GIF", **kw)
            assert like_cv2(tmp_path, bio.getvalue()) is not None
        bio = io.BytesIO()
        Image.fromarray(img[..., 0]).convert("P").save(bio, "GIF",
                                                        transparency=3)
        assert like_cv2(tmp_path, bio.getvalue()) is not None


@pytest.mark.parametrize("mcs", [2, 3, 4, 5, 6, 7, 8])
def test_code_sizes_and_interlace(tmp_path, mcs):
    """Every minimum code size, global and local tables, interlaced or
    not, GIF87a and GIF89a, at heights 1..17 (every interlace class)."""
    rng = np.random.RandomState(mcs)
    n = 1 << mcs
    for h in (1, 2, 3, 5, 8, 9, 17):
        index = rng.randint(0, n, (h, 11))
        for interlace in (False, True):
            for version in (b"87a", b"89a"):
                got = like_cv2(tmp_path, gif_bytes(11, h, [gif_image(
                    index, min_code_size=mcs, interlace=interlace)],
                    palette(rng, n), version=version))
                assert got is not None
            got = like_cv2(tmp_path, gif_bytes(11, h, [gif_image(
                index, min_code_size=mcs, interlace=interlace,
                palette=palette(rng, n))]))
            assert got is not None


def test_full_table(tmp_path):
    """Noise that fills the 4096-entry table: a Clear when it fills, and a
    deferred clear (12-bit codes with the table full)."""
    rng = np.random.RandomState(1)
    index = rng.randint(0, 256, (90, 110))
    for deferred in (False, True):
        got = like_cv2(tmp_path, gif_bytes(110, 90, [gif_image(
            index, deferred_clear=deferred)], palette(rng, 256)))
        assert got is not None


def test_canvas_and_transparency(tmp_path):
    """A frame smaller than the screen at an offset: the canvas is the
    global background colour (black without a global table), which a
    transparent index shows through under every disposal."""
    rng = np.random.RandomState(2)
    table = palette(rng, 16)
    index = rng.randint(0, 16, (9, 7))
    for disposal in (0, 1, 2, 3):
        for transparent, bg in ((5, 5), (5, 3), (None, 3), (0, 15)):
            for local in (False, True):
                frame = gif_image(index, left=4, top=3,
                                  transparent=transparent, disposal=disposal,
                                  palette=table[::-1] if local else None,
                                  min_code_size=4)
                got = like_cv2(tmp_path, gif_bytes(
                    13, 17, [frame], None if local else table,
                    background=bg))
                assert got is not None
    # indices past a short local table take the global colours
    got = like_cv2(tmp_path, gif_bytes(7, 9, [gif_image(
        index, palette=table[:4], min_code_size=4)], table))
    assert got is not None
    # past both tables: refused, unless that index is the transparent one
    assert like_cv2(tmp_path, gif_bytes(7, 9, [gif_image(
        index, min_code_size=4)], table[:8])) is None
    index[index >= 8] = 9
    assert like_cv2(tmp_path, gif_bytes(7, 9, [gif_image(
        index, min_code_size=4, transparent=9)], table[:8])) is not None
    # neither table: cv2's default colours
    got = like_cv2(tmp_path, gif_bytes(16, 16, [gif_image(
        np.arange(256).reshape(16, 16))]))
    assert got is not None


def test_extensions_and_frames(tmp_path):
    rng = np.random.RandomState(3)
    table = palette(rng, 16)
    index = rng.randint(0, 16, (6, 8))
    frame = gif_image(index, min_code_size=4)
    extensions = (b"\x21\xfe" + gif_blocks(b"a comment")
                  + b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
                  + b"\x21\x01" + gif_blocks(bytes(13))
                  + b"\x21\x77" + gif_blocks(b"xyz")
                  # an EXIF block with Orientation 6, which cv2 ignores
                  + b"\x21\xff" + gif_blocks(b"EXIFxxxxxxx")[:-1]
                  + gif_blocks(b"Exif\0\0II*\0\x08\0\0\0\x01\0\x12\x01\x03\0"
                               b"\x01\0\0\0\x06\0\0\0\0\0\0\0")
                  + b"\x21\xf9\x04\x01\x00\x00\x05\x00")   # overridden
    bad = (b"," + struct.pack("<HHHHB", 0, 0, 8, 6, 0) + b"\x04"
           + gif_blocks(b"\xff" * 4))
    for frames in ([frame], [gif_image(index, min_code_size=4,
                                       transparent=9)],
                   [frame, frame], [frame, bad],
                   [frame, gif_image(index, left=5, min_code_size=4)]):
        got = like_cv2(tmp_path, gif_bytes(8, 6, frames, table,
                                           extensions=extensions))
        assert got is not None
    assert like_cv2(tmp_path, gif_bytes(8, 6, [frame], table)
                    + b"after the trailer") is not None


def test_hand_made_code_streams(tmp_path):
    """mcs 2 (Clear 4, End 5): the End code missing (the padding decodes
    as colour 0), short frames, a first code that is not a colour, codes
    past the table."""
    table = np.arange(12).reshape(4, 3) * 20
    seq = [1, 2, 3, 0, 1, 2]
    cases = [  # (width, codes, cv2 reads it)
        (5, [4, 1, 2, 6, 3, 5], True),
        (4, [4, 1, 6, 2, 5], True),                 # KwKwK
        (5, [4, 1, 2, 7, 3, 5], True),              # the next code
        (3, [4, 1, 2, 3], True),                    # no End code
        (4, [4, 1, 2], True),                       # padding decoded
        (3, [4, 1, 2, 4, 3, 5], True),              # a Clear inside
        (3, [1, 2, 3, 5], True),                    # no Clear first
        (4, [4] + seq[:2] + [5], False),            # short of pixels
        (6, [4] + seq[:4] + [5], False),
        (6, [4] + seq[:4], False),
        (4, [4, 6, 1, 2, 5], False),                # first code not a colour
        (4, [4, 1, 7, 2, 5], False),                # past the table
        (1, [4, 5], False),
    ]
    for w, codes, reads in cases:
        got = like_cv2(tmp_path, gif_bytes(w, 1, [raw_frame(w, 1, codes)],
                                           table))
        assert (got is not None) == reads, codes


PAST_THE_FRAME = {  # name: (width, min code size, codes, cv2 reads it)
    # a byte may be read only while at most width x height pixels came
    "a colour past, End": (4, 8, [256, 1, 2, 3, 4, 5, 257], False),
    "a colour past, no End": (4, 8, [256, 1, 2, 3, 4, 5], True),
    "two colours past, no End": (4, 8, [256, 1, 2, 3, 4, 5, 6], False),
    "a colour after the End code": (4, 8, [256, 1, 2, 3, 4, 257, 1], True),
    # a string that starts inside the frame must end inside it; one that
    # starts at its end is counted past it
    "a string from the frame's end": (1, 2, [4, 1, 6, 5], True),
    "a string across the frame's end": (2, 2, [4, 1, 6, 5], False),
    "1 2 then a string from the end": (2, 2, [4, 1, 2, 6, 5], True),
    "1 2 then a string across the end": (3, 2, [4, 1, 2, 6, 5], False),
    "four then a string from the end": (4, 2, [4, 1, 2, 3, 1, 7, 5], True),
    "four then a string across": (5, 2, [4, 1, 2, 3, 1, 7, 5], False),
}


@pytest.mark.parametrize("name", list(PAST_THE_FRAME))
def test_codes_past_the_frame(tmp_path, name):
    """LZW data holding more pixels than a one-row frame, as cv2 5.0's
    lzwDecode takes them (its checks found by probing it)."""
    w, mcs, codes, reads = PAST_THE_FRAME[name]
    table = np.arange(3 << mcs).reshape(1 << mcs, 3) % 256
    got = like_cv2(tmp_path, gif_bytes(w, 1, [raw_frame(w, 1, codes, mcs)],
                                       table))
    assert (got is not None) == reads


AFTER_END = {  # name: (width, codes, the port's indices or None)
    "colours after an early End": (4, [4, 1, 2, 5, 3, 0], [1, 2, 3, 0]),
    "a table built after the End": (5, [4, 1, 2, 5, 3, 6], [1, 2, 3, 3, 3]),
    "strings from the table since the End": (6, [4, 1, 2, 5, 2, 3, 6],
                                             [1, 2, 2, 3, 2, 3]),
    "a table code first after the End": (4, [4, 1, 2, 5, 6, 1], None),
    "a code past the table since the End": (4, [4, 1, 2, 5, 3, 7], None),
}


@pytest.mark.parametrize("name", list(AFTER_END))
def test_codes_after_the_end_code(tmp_path, name):
    """The port's rule for LZW codes after an End code (mcs 2: Clear 4,
    End 5): they decode on as after a Clear, from an empty table.  cv2
    5.0's lzwDecode empties its table there without resizing it and reads
    on through the emptied entries; its output was the same in every
    process that probed it, but its rule was not found, so this is a
    deliberate difference (ROADMAP, "Deliberate differences") and only
    the port's output is held here."""
    w, codes, want = AFTER_END[name]
    table = np.arange(12).reshape(4, 3) * 20
    path = tmp_path / "end.gif"
    path.write_bytes(gif_bytes(w, 1, [raw_frame(w, 1, codes)], table))
    if want is None:
        with pytest.raises(native.ImageError, match="GIF: .*LZW"):
            native.decode_image(str(path))
    else:
        np.testing.assert_array_equal(native.decode_image(str(path))[0],
                                      table[want])


def test_refused(tmp_path):
    rng = np.random.RandomState(4)
    table = palette(rng, 16)
    index = rng.randint(0, 16, (6, 8))
    frame = gif_image(index, min_code_size=4)
    good = gif_bytes(8, 6, [frame], table)
    assert like_cv2(tmp_path, good) is not None
    for data in (b"GIF89a" + bytes(40),
                 good[:8] + b"\x00\x00" + good[10:],          # height 0
                 gif_bytes(8, 6, [frame], table, background=16),
                 gif_bytes(8, 6, [gif_image(index, left=1, min_code_size=4)],
                           table),
                 gif_bytes(8, 6, [], table),
                 gif_bytes(8, 6, [b"\x21\xf9\x05" + bytes(6) + frame], table),
                 gif_bytes(8, 6, [frame, b"\x00"], table),
                 gif_bytes(8, 6, [raw_frame(8, 6, [4, 1], mcs=1)], table),
                 good[:-1], good[:-5], good[:40]):
        assert like_cv2(tmp_path, data) is None
    path = tmp_path / "x.jpg"
    path.write_bytes(b"GIF89a" + bytes(40))
    with pytest.raises(native.ImageError, match="GIF"):
        common.load_image_rgb(str(path))
    assert formats.sniff(b"GIF87a") == formats.sniff(b"GIF89a") == "GIF"
