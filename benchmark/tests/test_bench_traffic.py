"""Inputs come from the seed alone: the same seed, the same traffic; another
seed, other traffic (the same set of lengths in another order)."""
import numpy as np
import torch

from benchmark.harness.signals import (seed_seq, side, stereo_take,
                                       stream_block)
from benchmark.harness.system import build_models
from benchmark.tests.conftest import ROOT

BIG = 2 ** 31 + 12345


def _gen(seed, *stream):
    return torch.Generator().manual_seed(seed_seq(seed, *stream))


def test_seed_streams_take_large_seeds():
    assert seed_seq(BIG, 1) == seed_seq(BIG, 1)
    assert seed_seq(BIG, 1) != seed_seq(BIG + 1, 1)
    assert 0 <= seed_seq(BIG, 2) < 2 ** 63


def test_sides_repeat_by_seed():
    a, b = side(50000, 22050, _gen(BIG, 2)), side(50000, 22050, _gen(BIG, 2))
    c = side(50000, 22050, _gen(BIG + 1, 2))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert 0.05 < float(a.pow(2).mean().sqrt()) < 0.2


def test_stream_blocks_and_corpus_repeat_by_seed():
    p = stream_block(3, 4000, 8000, 22050, _gen(7, 1, 2))
    assert torch.equal(p, stream_block(3, 4000, 8000, 22050, _gen(7, 1, 2)))
    assert not torch.equal(p, stream_block(3, 4000, 8000, 22050,
                                           _gen(8, 1, 2)))
    assert not torch.equal(p[0], p[1])
    assert 0.05 < float(p.pow(2).mean().sqrt()) < 0.2
    s = stereo_take(3000, seed_seq(7, 10, 0))
    assert np.array_equal(s, stereo_take(3000, seed_seq(7, 10, 0)))
    assert not np.array_equal(s, stereo_take(3000, seed_seq(8, 10, 0)))


def test_restore_mix_is_one_set_of_lengths_in_seeded_orders():
    import json

    mix = json.loads((ROOT / "benchmark/traffic/restore_78_sides.json")
                     .read_text())
    k = mix["side_seconds"]["count"]
    orders = [np.random.default_rng(seed_seq(s, 1)).permutation(k)
              for s in (1, 1, 2)]
    assert np.array_equal(orders[0], orders[1])
    assert not np.array_equal(orders[0], orders[2])
    assert sorted(orders[2]) == list(range(k))


def test_weights_repeat_by_seed():
    import json

    c = json.loads((ROOT / "benchmark/configs/f32_default.json").read_text())
    a = build_models(c, "cpu", BIG, ("super_resolution",))
    b = build_models(c, "cpu", BIG, ("super_resolution",))
    d = build_models(c, "cpu", BIG + 1, ("super_resolution",))
    sa, sb, sd = (m["super_resolution"].state_dict() for m in (a, b, d))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["initial.0.weight"], sd["initial.0.weight"])
