"""Port parity: cbird_tpu_torch's DCT hash and autocrop against cbird_tpu's.

The conftest ``images`` (and letterboxed copies) go through both
``hash_batch`` functions on a small canvas.  Crop boxes must be equal
exactly.  Hashes are held to <= 1 bit per hash, the bar the JAX package
holds itself to against its numpy golden (tests/test_dct_hash.py): every
DCT coefficient is compared against the mean of 64, so one sitting at the
mean can flip when a sum is taken in another order.  The number of
flipped hashes is printed.
"""

import numpy as np
import pytest
import torch

from cbird_tpu.ops import dct_hash as jd
from cbird_tpu.ops import ref_numpy as ref
from cbird_tpu_torch.ops import dct_hash as td

torch.set_num_threads(1)

CANVAS = 512


def _letterbox(img, pad):
    h, w = img.shape
    out = np.zeros((h + 2 * pad, w), np.uint8)
    out[pad:pad + h] = img
    return out


@pytest.fixture(scope="module")
def batch(images):
    """8 images: the conftest corpus (last one replaced by a letterboxed
    copy of the first, which autocrop must find)."""
    imgs = list(images[:7]) + [_letterbox(images[0][:, :300], 50)]
    return imgs, *jd.pack_canvas(imgs, CANVAS, CANVAS)


def _flips(a, b):
    d = np.bitwise_count(np.asarray(a, np.uint64) ^ np.asarray(b, np.uint64))
    return d


@pytest.mark.parametrize("do_crop", [False, True])
def test_hash_batch_matches_jax(batch, do_crop):
    _, canvas, sizes = batch
    pairs, boxes = jd.hash_batch(canvas, sizes, do_crop=do_crop)
    want = jd.combine_u32(np.asarray(pairs))
    got, got_boxes = td.hash_batch(torch.from_numpy(canvas),
                                   torch.from_numpy(sizes), do_crop=do_crop)
    assert np.array_equal(got_boxes.numpy(), np.asarray(boxes))
    flips = _flips(got.numpy().view(np.uint64), want)
    print(f"do_crop={do_crop}: {np.count_nonzero(flips)} of {len(flips)} "
          f"hashes differ from cbird_tpu (max {flips.max()} bit)")
    assert flips.max() <= 1
    if do_crop:  # the letterbox was found and cropped away
        assert tuple(got_boxes[7].tolist()) == (50, 50 + 400, 0, 300)


def test_hasher_matches_jax_and_golden(batch):
    imgs = batch[0]
    got = td.DctHasher(canvas_hw=(CANVAS, CANVAS), batch=3,
                       device="cpu").hash_images(imgs)
    want = jd.DctHasher(canvas_hw=(CANVAS, CANVAS),
                        batch=8).hash_images(imgs)
    gold = np.array([ref.dct_hash64(img) for img in imgs], dtype=np.uint64)
    assert got.dtype == np.uint64 and len(got) == len(imgs)
    assert _flips(got, want).max() <= 1
    assert _flips(got, gold).max() <= 1
    assert td.DctHasher(device="cpu").hash_images([]).shape == (0,)


def test_u64_layout_helpers():
    h = np.array([0, 1, 2**63, 2**64 - 1, 0x123456789ABCDEF0], np.uint64)
    assert np.array_equal(td.split_u64(h), jd.split_u64(h))
    assert np.array_equal(td.combine_u32(td.split_u64(h)), h)


def test_oversized_image_raises():
    with pytest.raises(ValueError):
        td.pack_canvas([np.zeros((40, 10), np.uint8)], 32, 32)
