"""The traffic generator: one seed gives the same traffic, two seeds give
different traffic over the same set of sizes and arrivals."""

import numpy as np
import torch

from benchlib import seeds, traffic

BIG = 2 ** 31 + 12345


def test_windows_repeat_for_a_seed_and_differ_across_seeds():
    a = traffic.windows(4, 2, (32, 48), BIG, "cpu")
    b = traffic.windows(4, 2, (32, 48), BIG, "cpu")
    c = traffic.windows(4, 2, (32, 48), BIG + 1, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (4, 2, 32, 48, 3)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    # every window differs from every other
    flat = a.reshape(4, -1)
    assert all(not torch.equal(flat[i], flat[j])
               for i in range(4) for j in range(i + 1, 4))


def test_captions_same_lengths_in_another_order():
    a = traffic.captions(16, 40, 5, 40, 30522, BIG, "cpu")
    b = traffic.captions(16, 40, 5, 40, 30522, BIG, "cpu")
    c = traffic.captions(16, 40, 5, 40, 30522, 3, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    la, lc = (a != 0).sum(1), (c != 0).sum(1)
    assert sorted(la.tolist()) == sorted(lc.tolist())
    assert not torch.equal(la, lc)
    assert bool((a[:, 0] == traffic.CLS).all())
    assert int(la.min()) == 5 and int(la.max()) == 40
    for row, n in zip(a, la):
        assert int(row[n - 1]) == traffic.SEP


def test_order_cycles_the_pool():
    a = traffic.order(5, 12, BIG)
    assert a == traffic.order(5, 12, BIG)
    assert a != traffic.order(5, 12, BIG + 1)
    assert sorted(a[:5]) == list(range(5))
    assert sorted(a[5:10]) == list(range(5))


def test_sub_seeds_take_large_and_negative_seeds():
    assert seeds.sub_seed(BIG, 1) != seeds.sub_seed(BIG + 1, 1)
    assert seeds.sub_seed(BIG, 1) != seeds.sub_seed(BIG, 2)
    assert 0 <= seeds.sub_seed(-7, 1) < 2 ** 63
    g1 = seeds.step_generator(BIG, 3)
    g2 = seeds.step_generator(BIG, 3)
    assert torch.equal(torch.rand(4, generator=g1),
                       torch.rand(4, generator=g2))
