"""The port's teacher-output caches against the JAX package's
(``rtvc_tpu/data/teacher_cache.py``).

The caches are numpy on disk, so a directory written by either package must
replay in the other, entry for entry and bit for bit; ``densify_topk``
must give JAX's dense logits bit for bit. The port's ``CacheReplayFeed``
hands out torch tensors (on the CPU here; on a card they arrive through a
side stream) and must prefetch, reap its producer when the consumer stops,
and refuse batches without ids as JAX's does.
"""

import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.data import teacher_cache as jcache
from rtvc_tpu_torch.data import teacher_cache as pcache

V = 37  # vocab
T = 5   # positions


def logits(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, T, V)).astype(
        np.float32) * 3


def beams(n, seed=1):
    rng = np.random.default_rng(seed)
    preds = rng.integers(0, V, size=(n, 6)).astype(np.int32)
    return preds, rng.normal(size=(n, 5, V)).astype(np.float32)


def make(mod, kind, path, top_k=0, **kw):
    if kind == "logits":
        return mod.TeacherLogitsCache(str(path), top_k=top_k, **kw)
    return mod.TeacherBeamCache(str(path), top_k=top_k, beam_size=2,
                                max_steps=6, **kw)


def put(cache, kind, keys, seed=0):
    if kind == "logits":
        cache.put_batch(keys, logits(len(keys), seed))
    else:
        cache.put_batch(keys, *beams(len(keys), seed))


def got_arrays(cache, kind, keys):
    out = cache.get_batch(keys)
    if out is None:
        return None
    if kind == "logits":
        return list(out) if isinstance(out, tuple) else [out]
    return [out[k] for k in sorted(out)]


KINDS = ["logits", "beam"]


@pytest.mark.parametrize("top_k", [0, 8])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_a_cache_dir_replays_in_either_package(tmp_path, kind, top_k,
                                               writer, reader):
    mods = {"port": pcache, "jax": jcache}
    keys = ["video7", "video9__3", "a/b c"]
    put(make(mods[writer], kind, tmp_path, top_k), kind, keys, seed=4)
    # what the writing package itself reads back
    want = got_arrays(make(mods[writer], kind, tmp_path, top_k), kind, keys)
    got = got_arrays(make(mods[reader], kind, tmp_path, top_k), kind, keys)
    assert len(got) == len(want) == (2 if kind == "logits" and top_k
                                     else 1 if kind == "logits"
                                     else 3 if top_k else 2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # the full-vocab entries are the values written
    if not top_k:
        src = logits(3, 4) if kind == "logits" else beams(3, 4)[1]
        assert np.array_equal(got[0], src)  # "kd" sorts first
    files = sorted(os.listdir(tmp_path))
    assert files == sorted(os.path.basename(make(pcache, kind, tmp_path,
                                                 top_k)._path(k))
                           for k in keys)


@pytest.mark.parametrize("kind", KINDS)
def test_stats_and_partial_batches(tmp_path, kind):
    cache = make(pcache, kind, tmp_path)
    assert cache.get_batch(["x", "y"]) is None
    put(cache, kind, ["x"])
    assert cache.get_batch(["x", "y"]) is None     # partial: whole miss
    assert got_arrays(cache, kind, ["x"]) is not None
    assert cache.stats() == {"hits": 1, "misses": 4}


@pytest.mark.parametrize("kind", KINDS)
def test_a_change_of_top_k_misses(tmp_path, kind):
    put(make(pcache, kind, tmp_path, top_k=8), kind, ["x"])
    assert make(pcache, kind, tmp_path, top_k=4).get_batch(["x"]) is None
    assert make(pcache, kind, tmp_path, top_k=0).get_batch(["x"]) is None
    assert make(pcache, kind, tmp_path, top_k=8).get_batch(["x"]) is not None


def test_a_change_of_beam_misses(tmp_path):
    pcache.TeacherBeamCache(str(tmp_path), beam_size=2).put_batch(
        ["v"], *beams(1))
    for kw in (dict(beam_size=3), dict(max_steps=10),
               dict(length_penalty=1.0), dict(store_consensus=False)):
        assert pcache.TeacherBeamCache(str(tmp_path),
                                       **dict(dict(beam_size=2), **kw)
                                       ).get_batch(["v"]) is None
    toks = pcache.TeacherBeamCache(str(tmp_path), store_consensus=False)
    toks.put_batch(["v"], beams(1)[0])
    assert set(toks.get_batch(["v"])) == {"predictions"}
    with pytest.raises(ValueError, match="kd_logits"):
        pcache.TeacherBeamCache(str(tmp_path)).put_batch(["v"], beams(1)[0])


@pytest.mark.parametrize("kind", KINDS)
def test_a_corrupt_entry_is_a_miss(tmp_path, kind):
    cache = make(pcache, kind, tmp_path)
    put(cache, kind, ["a", "b"])
    assert all(".tmp" not in f for f in os.listdir(tmp_path))
    with open(cache._path("a"), "wb") as f:
        f.write(b"\x93NUMPY garbage")
    assert cache.get_batch(["a", "b"]) is None
    put(cache, kind, ["a", "b"])                   # the rewrite repairs it
    assert cache.get_batch(["a", "b"]) is not None


def test_eviction_keeps_the_newest_within_the_budget(tmp_path):
    one = logits(1)[0].nbytes + 128
    cache = pcache.TeacherLogitsCache(str(tmp_path), max_bytes=3 * one)
    for i in range(5):
        cache.put_batch([f"k{i}"], logits(1, i))
        os.utime(cache._path(f"k{i}"), (i, i))     # a strict age order
    cache.put_batch(["k5"], logits(1, 5))
    left = sorted(os.listdir(tmp_path))
    assert len(left) == 3
    assert cache.get_batch(["k5"]) is not None
    assert cache.get_batch(["k0"]) is None


@pytest.mark.parametrize("k", [1, 8, V, V + 5])
def test_densify_topk_equals_jax(k):
    cache = pcache.TeacherLogitsCache.__new__(pcache.TeacherLogitsCache)
    cache.top_k = k
    dense = logits(3, 2)
    vals, idx = cache.compress(dense)
    want = np.asarray(jcache.densify_topk(jnp.asarray(vals),
                                          jnp.asarray(idx), V))
    got = pcache.densify_topk(torch.from_numpy(vals), torch.from_numpy(idx),
                              V)
    assert got.dtype == torch.float32 and got.shape == (3, T, V)
    assert np.array_equal(got.numpy(), want)
    if k >= V:  # lossless when K covers the vocabulary
        assert np.array_equal(got.numpy(), dense)
    else:  # the rest sits 100 below the row max: probability < e^-100
        probs = torch.softmax(got, -1)
        kept = torch.zeros_like(probs, dtype=torch.bool).scatter_(
            -1, torch.from_numpy(idx).long(), True)
        assert float(probs[~kept].max()) < 1e-43


def _loader(n_batches, b=2, tag="v"):
    return [{"frames": torch.zeros(b, 1), "caption": torch.zeros(b, 3),
             "vid-id": [f"{tag}{i}_{j}" for j in range(b)],
             "caption-id": list(range(b))} for i in range(n_batches)]


@pytest.mark.parametrize("top_k", [0, 8])
def test_replay_feed_hands_out_hits_and_keys(tmp_path, top_k):
    loader = _loader(3)
    cache = pcache.TeacherLogitsCache(str(tmp_path / "l"), top_k=top_k)
    beam = pcache.TeacherBeamCache(str(tmp_path / "b"), top_k=top_k,
                                   beam_size=2, max_steps=6)
    want = {}
    for i, batch in enumerate(loader[:2]):        # batch 2 stays a miss
        keys = [cache.key(v, c) for v, c in zip(batch["vid-id"],
                                                batch["caption-id"])]
        cache.put_batch(keys, logits(2, i))
        beam.put_batch(batch["vid-id"], *beams(2, i))
        want[i] = (cache.get_batch(keys), beam.get_batch(batch["vid-id"]))
    out = list(pcache.CacheReplayFeed(loader, cache, beam_cache=beam,
                                      device="cpu"))
    assert len(out) == 3
    for i, batch in enumerate(out):
        assert batch["_cache_keys"] == [f"v{i}_{j}__{j}" for j in range(2)]
        assert batch["_beam_cache_keys"] == loader[i]["vid-id"]
        if i == 2:
            assert not any(k.startswith("teacher_") for k in batch)
            continue
        logit_hit, beam_hit = want[i]
        if top_k:
            assert np.array_equal(batch["teacher_topk_vals"].numpy(),
                                  logit_hit[0])
            assert batch["teacher_topk_idx"].dtype == torch.int32
            assert np.array_equal(batch["teacher_kd_vals"].numpy(),
                                  beam_hit["kd_vals"])
            assert np.array_equal(batch["teacher_kd_idx"].numpy(),
                                  beam_hit["kd_idx"])
        else:
            assert batch["teacher_logits"].dtype == torch.float32
            assert np.array_equal(batch["teacher_logits"].numpy(), logit_hit)
            assert np.array_equal(batch["teacher_kd_logits"].numpy(),
                                  beam_hit["kd"])
        assert np.array_equal(batch["teacher_beam_predictions"].numpy(),
                              beam_hit["predictions"])


def test_replay_feed_mesh_hands_out_this_ranks_rows(tmp_path):
    """``CacheReplayFeed(mesh=...)``, as JAX's shards its hits over dp:
    each dp rank's feed uploads its share of every hit's rows, the keys
    stay the batch's; a loader that yields its rank's rows already keeps
    its hits whole."""
    import collections

    from rtvc_tpu_torch.parallel.mesh import Mesh

    def rank(i):
        return Mesh(collections.OrderedDict(dp=2, tp=1),
                    torch.device("cpu"), {"dp": i, "tp": 0}, {}, None, True)

    loader = _loader(2)
    cache = pcache.TeacherLogitsCache(str(tmp_path / "l"))
    whole = []
    for i, batch in enumerate(loader):
        keys = [cache.key(v, c) for v, c in zip(batch["vid-id"],
                                                batch["caption-id"])]
        cache.put_batch(keys, logits(2, i))
        whole.append(cache.get_batch(keys))
    ranks = [list(pcache.CacheReplayFeed(loader, cache, device="cpu",
                                         mesh=rank(i))) for i in range(2)]
    for j, (a, b) in enumerate(zip(*ranks)):
        assert a["_cache_keys"] == b["_cache_keys"]  # the batch's keys
        assert a["teacher_logits"].shape[0] == 1
        got = torch.cat([a["teacher_logits"], b["teacher_logits"]])
        assert np.array_equal(got.numpy(), whole[j])

    class RankLoader(list):
        host_slice = (0, 2)

    kept = list(pcache.CacheReplayFeed(RankLoader(loader), cache,
                                       device="cpu", mesh=rank(1)))
    assert np.array_equal(kept[0]["teacher_logits"].numpy(), whole[0])


def test_replay_feed_prefetches_ahead_of_the_consumer(tmp_path):
    cache = pcache.TeacherLogitsCache(str(tmp_path))
    read = []
    real = cache.get_batch

    def get_batch(keys):
        read.append(keys[0])
        return real(keys)

    cache.get_batch = get_batch
    it = iter(pcache.CacheReplayFeed(_loader(4), cache, depth=2,
                                     device="cpu"))
    next(it)
    deadline = 1000                                # 10 s
    while len(read) < 3 and deadline:              # batches 1 and 2 read
        threading.Event().wait(0.01)               # while 0 is "running"
        deadline -= 1
    assert len(read) >= 3
    assert len(list(it)) == 3


def test_replay_feed_reaps_its_producer_when_abandoned(tmp_path):
    cache = pcache.TeacherLogitsCache(str(tmp_path))
    before = {t.ident for t in threading.enumerate()}
    it = iter(pcache.CacheReplayFeed(_loader(20), cache, depth=1,
                                     device="cpu"))
    next(it)
    it.close()                                     # the consumer gives up
    left = [t for t in threading.enumerate()
            if t.ident not in before and t.name == "cache-replay-producer"]
    assert left == []


@pytest.mark.parametrize("drop,beam", [("caption-id", False),
                                       ("vid-id", True)])
def test_replay_feed_needs_ids(tmp_path, drop, beam):
    batch = dict(_loader(1)[0])
    del batch[drop]
    kw = (dict(cache=None, beam_cache=pcache.TeacherBeamCache(
        str(tmp_path))) if beam
        else dict(cache=pcache.TeacherLogitsCache(str(tmp_path))))
    with pytest.raises(ValueError, match="vid-id"):
        list(pcache.CacheReplayFeed([batch], device="cpu", **kw))
