"""The port's BCn block decoders (irgs_tpu_torch/csrc/bcn_decode.cpp
through utils/bcn.py and the DDS reader) against libImaging's BcnDecode.c
through PIL, bit for bit, on seeded random blocks: BC1-BC5 and BC5S,
every BC7 mode (8 for a zero first byte) with every partition of its
2- and 3-subset modes, every BC6H mode (and the reserved ones) with every
partition, unsigned and signed; images whose sides are not multiples of
4, whose blocks are clipped; data that ends before the last block,
refused where PIL refuses it. The DXT decoders of BLP2 are held against
BlpImagePlugin's in tests/test_torch_blp.py. Tolerance: none."""

import numpy as np
import pytest
from PIL import Image

import image_streams as ims
from irgs_tpu_torch.utils import bcn, dds, image
from test_torch_mis import one_torch_thread  # noqa: F401

# pixel format -> DXGI format
DXGI = {"BC1": 71, "BC2": 74, "BC3": 77, "BC4": 80, "BC5": 83, "BC5S": 84,
        "BC6H": 95, "BC6HS": 96, "BC7": 98}
# BC7 mode -> partition bits; BC6H's two-region modes carry 5 at bit 77
BC7_PARTITION_BITS = {0: 4, 1: 6, 2: 6, 3: 6, 4: 0, 5: 0, 6: 0, 7: 6}


def _size(fmt):
    return bcn.block_bytes(bcn.FORMATS[fmt][0])


def _as_pil(tmp_path, fmt, w, h, data):
    """(PIL's array, the port's) of a DX10 DDS of `data`."""
    path = tmp_path / f"{fmt}_{w}x{h}.dds"
    path.write_bytes(ims.write_dds(w, h, data, dxgi=DXGI[fmt]))
    with Image.open(path) as im:
        want = np.asarray(im)
    got, mode, _ = dds.read_dds_like_pil(str(path))
    assert mode == {"BC4": "L", "BC5": "RGB", "BC5S": "RGB", "BC6H": "RGB",
                    "BC6HS": "RGB"}.get(fmt, "RGBA")
    return want, got


def _check_blocks(tmp_path, fmt, blocks):
    """The blocks (ints of 64 or 128 bits) as an image 64 blocks wide."""
    size = _size(fmt)
    n = -(-len(blocks) // 64) * 64
    blocks = list(blocks) + [0] * (n - len(blocks))
    data = b"".join(b.to_bytes(size, "little") for b in blocks)
    want, got = _as_pil(tmp_path, fmt, 256, 4 * (n // 64), data)
    np.testing.assert_array_equal(got, want)


def _random_ints(rng, n, bits):
    return [int.from_bytes(rng.bytes(bits // 8), "little") for _ in range(n)]


@pytest.mark.parametrize("fmt", ["BC1", "BC2", "BC3", "BC4", "BC5", "BC5S"])
def test_random_blocks_equal_pil(fmt, tmp_path):
    """2,048 random blocks, a quarter of them with the endpoints ordered the
    other way (BC1's three-colour mode, BC3-5's six-value alpha)."""
    rng = np.random.default_rng(list(DXGI).index(fmt))
    size = _size(fmt)
    blocks = _random_ints(rng, 2048, 8 * size)
    for i in range(0, len(blocks), 4):
        b = blocks[i].to_bytes(size, "little")
        at = size - 8 if fmt in ("BC1", "BC2", "BC3") else 0
        lo = b[at:at + 2] if fmt in ("BC1", "BC2", "BC3") else b[at:at + 1]
        hi = b[at + 2:at + 4] if fmt in ("BC1", "BC2", "BC3") else \
            b[at + 1:at + 2]
        if lo > hi:                # swap so that the first is not larger
            n = len(lo)
            b = b[:at] + hi + lo + b[at + 2 * n:]
        blocks[i] = int.from_bytes(b, "little")
    _check_blocks(tmp_path, fmt, blocks)


def test_bc7_every_mode_and_partition(tmp_path):
    """8 random blocks for each partition of each BC7 mode (16 for modes
    without partitions, rotations and index selection random), and 16
    blocks of the reserved mode 8 (a zero first byte)."""
    rng = np.random.default_rng(70)
    blocks = []
    for mode, pb in BC7_PARTITION_BITS.items():
        for part in range(1 << pb):
            for b in _random_ints(rng, 8 if pb else 16, 128):
                low = mode + 1
                b = (b >> (low + pb) << (low + pb)) | (part << low) | (
                    1 << mode)
                blocks.append(b)
    blocks += [b >> 8 << 8 for b in _random_ints(rng, 16, 128)]
    assert len(blocks) == 8 * (16 + 4 * 64) + 3 * 16 + 16
    _check_blocks(tmp_path, "BC7", blocks)


@pytest.mark.parametrize("fmt", ["BC6H", "BC6HS"])
def test_bc6h_every_mode_and_partition(fmt, tmp_path):
    """4 random blocks for each partition of each two-region BC6H mode, 32
    for each one-region mode and 8 for each reserved mode value, unsigned
    (UF16) and signed (SF16)."""
    rng = np.random.default_rng(60 + (fmt == "BC6HS"))
    # mode index -> its mode bits (2 or 5) and their width
    modes = {0: (0, 2), 1: (1, 2)}
    modes.update({m: (2 | ((m - 2) << 2), 5) for m in range(2, 10)})
    modes.update({m: (3 | ((m - 10) << 2), 5) for m in range(10, 14)})
    blocks = []
    for m, (bits, width) in modes.items():
        parts = range(32) if m < 10 else [None] * 32
        for part in parts:
            for b in _random_ints(rng, 4 if part is not None else 1, 128):
                b = b >> width << width | bits
                if part is not None:
                    b = b & ~(31 << 77) | part << 77
                blocks.append(b)
    for bits in (19, 23, 27, 31):
        blocks += [b >> 5 << 5 | bits for b in _random_ints(rng, 8, 128)]
    assert len(blocks) == 10 * 32 * 4 + 4 * 32 + 32
    _check_blocks(tmp_path, fmt, blocks)


@pytest.mark.parametrize("fmt", ["BC1", "BC4", "BC6H", "BC7"])
@pytest.mark.parametrize("w,h", [(1, 1), (3, 5), (5, 3), (13, 9), (17, 2)])
def test_blocks_clipped_at_the_edges(fmt, w, h, tmp_path):
    rng = np.random.default_rng([w, h, len(fmt)])
    n = ((w + 3) // 4) * ((h + 3) // 4)
    want, got = _as_pil(tmp_path, fmt, w, h, rng.bytes(n * _size(fmt)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", sorted(DXGI))
def test_data_ending_early_raises(fmt, tmp_path):
    """One byte short of the last block: PIL's "image file is truncated",
    and the port's DdsError; the blocks complete: both read it."""
    rng = np.random.default_rng(len(fmt))
    data = rng.bytes(12 * _size(fmt))
    path = tmp_path / "short.dds"
    path.write_bytes(ims.write_dds(13, 9, data[:-1], dxgi=DXGI[fmt]))
    with pytest.raises(OSError, match="truncated"):
        with Image.open(path) as im:
            im.load()
    with pytest.raises(dds.DdsError, match="truncated"):
        image.read_image_like_pil(str(path))
    want, got = _as_pil(tmp_path, fmt, 13, 9, data)
    np.testing.assert_array_equal(got, want)
