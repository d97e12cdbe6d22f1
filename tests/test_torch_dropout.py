"""The port's dropout: the plain inverted dropout of the feature and
classifier layers, and the Philox bits of the fused epilogue (the plain
version of kernel C's mask, which chip_smoke.py holds the kernel to)."""

import numpy as np
import pytest
import torch

from vqa_project_tpu_torch.ops.dropout import (dropout, keep_threshold,
                                               philox4x32, philox_bits,
                                               philox_keep)

M32 = 0xFFFFFFFF


def _philox_python(ctr, key):
    """Philox4x32-10 in Python integers: the textbook form."""
    c, k = list(ctr), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & M32, (k[1] + 0xBB67AE85) & M32]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k[0]) & M32, p1 & M32,
             ((p0 >> 32) ^ c[3] ^ k[1]) & M32, p0 & M32]
    return c


@pytest.mark.parametrize("ctr,key,want", [
    # Random123's known-answer vectors for philox4x32_10
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    t = [torch.tensor([v], dtype=torch.int64) for v in ctr + key]
    got = philox4x32(tuple(t[:4]), tuple(t[4:]))
    assert tuple(int(w) for w in got) == want
    assert tuple(_philox_python(ctr, key)) == want


def test_philox_bits_match_python_for_signed_seeds(rng):
    seeds = torch.tensor([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 123456789],
                         dtype=torch.int32)
    ctr = torch.from_numpy(rng.integers(0, 2 ** 20, size=6))
    got = philox_bits(seeds, ctr)
    for s, c, g in zip(seeds.tolist(), ctr.tolist(), got.tolist()):
        assert g == _philox_python((c, 0, 0, 0), (s & M32, 0))[0]


def test_keep_mask_rate_and_independence():
    rate = 0.5
    seeds = torch.tensor([5, -7, 99], dtype=torch.int32)
    keep = philox_keep(seeds, (36, 512), rate)
    assert keep.shape == (3, 36, 512) and keep.dtype == torch.bool
    assert abs(float(keep.float().mean()) - 0.5) < 0.005
    # an image's mask depends on its own seed only
    np.testing.assert_array_equal(
        philox_keep(seeds[1:], (36, 512), rate).numpy(), keep[1:].numpy())
    assert keep_threshold(0.5) == 2 ** 31
    assert keep_threshold(1.0) == 2 ** 32 - 1
    assert abs(float(philox_keep(seeds, (36, 512), 0.4).float().mean())
               - 0.6) < 0.005


@pytest.mark.parametrize("rate", [0.5, 0.4])
def test_plain_dropout_keeps_the_exact_rate(rate):
    x = torch.ones(400_000)
    g = torch.Generator().manual_seed(3)
    y = dropout(x, rate, g)
    kept = y != 0
    # the configured rate, not the 1/256 grid of an 8-bit draw
    # (0.4 would keep 154/256 = 0.6016): 5 standard deviations is 0.004
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.004
    np.testing.assert_allclose(y[kept].numpy(), 1.0 / (1.0 - rate),
                               rtol=1e-7)
    again = dropout(x, rate, torch.Generator().manual_seed(3))
    assert torch.equal(y, again)


def test_plain_dropout_dtype_and_identity():
    x = torch.randn(64, 10).to(torch.bfloat16)
    y = dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert y.dtype == torch.bfloat16
    assert torch.equal(y[y != 0], (x * 2)[y != 0])
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError):
        dropout(x, 1.0, None)
