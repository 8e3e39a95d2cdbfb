"""The port's data layer against the JAX package's
(rtvc_tpu_torch.data vs rtvc_tpu.data).

- ``video_handlers`` and ``frame_sampling``: the copies give the
  originals' frames on tests/test_data.py's synthetic mp4, function by
  function and through their CLIs;
- ``load_labels``: the csv table the port reads holds the DataFrame's
  columns and answers its two questions (a video's caption ids, a split's
  videos) as pandas does;
- ``CaptionDataset`` (JAX given the DataFrame, the port the csv table, both
  read from one CSV, and the port the DataFrame too) and ``collate_batch``
  give the same items; the caption choice is pandas' ``Series.sample``;
- ``DeviceLoader`` on the CPU: the same batch order, ids, captions and
  caption ids, preprocessed frames within 1e-4 (the tolerance of
  ``test_clip_preprocess_matches_jax``), the same shuffle order per epoch
  and after ``set_epoch``, the same ``host_slice`` rows, ``num_workers=2``
  equal to inline, the ragged last batch kept or dropped;
- the evaluation modules import with pandas and cv2 blocked.

:func:`write_msrvtt` writes the MSRVTT-format tree the evaluation tests
share.
"""

import csv
import json
import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.data import dataset as jds
from rtvc_tpu.data import frame_sampling as jfs
from rtvc_tpu.data import video_handlers as jvh
from rtvc_tpu_torch.data import dataset as pds
from rtvc_tpu_torch.data import frame_sampling as pfs
from rtvc_tpu_torch.data import video_handlers as pvh
from rtvc_tpu_torch.tokenization import (BertWordPieceTokenizer,
                                         encode_caption)

TOL = 1e-4          # test_clip_preprocess_matches_jax's
CLIP_HW = (48, 64)  # clip frames, small: the loader resizes to 224


def write_msrvtt(root, n_videos=11, seed=0, frames=14, hw=CLIP_HW,
                 splits=("test",), mp4=()):
    """An MSRVTT-format tree under ``root``, numpy/csv/json/pickle only:
    ``videos/<vid>.npy`` uint8 noise clips ``[frames, H, W, 3]``, each at
    its own brightness (``mp4`` names
    the videos written as mp4 instead, through OpenCV), ``labels.csv``
    (``image_id,id,caption,split``, 1-7 captions a video in shuffled row
    order, caption ids not in row order), ``encoded_captions.pkl`` (the
    tokenizer's ``encode_caption`` rows) and ``MSR_VTT.json``. Returns the
    paths."""
    rng = np.random.default_rng(seed)
    words = ("a man woman dog is playing riding singing guitar car on the "
             "street in kitchen with ball").split()
    tok = BertWordPieceTokenizer()
    vids = os.path.join(root, "videos")
    os.makedirs(vids, exist_ok=True)
    rows = []
    for i in range(n_videos):
        vid = f"video{i}"
        # each clip at its own brightness, so that the rows differ
        clip = (rng.integers(0, 255, size=(frames,) + hw + (3,))
                * rng.uniform(0.1, 1.0)).astype(np.uint8)
        if vid in mp4:
            import cv2
            w = cv2.VideoWriter(os.path.join(vids, vid + ".mp4"),
                                cv2.VideoWriter_fourcc(*"mp4v"), 10,
                                (hw[1], hw[0]))
            if not w.isOpened():
                pytest.skip("no mp4 codec available")
            for frame in clip:
                w.write(frame)
            w.release()
        else:
            np.save(os.path.join(vids, vid + ".npy"), clip)
        split = splits[i % len(splits)]
        for _ in range(int(rng.integers(1, 8))):
            caption = " ".join(rng.choice(words, size=int(rng.integers(3,
                                                                       9))))
            rows.append([vid, 0, caption, split])
    order = rng.permutation(len(rows))
    rows = [rows[k] for k in order]
    ids = rng.permutation(len(rows)) * 3 + 7
    encoded = {}
    for r, cid in zip(rows, ids):
        r[1] = int(cid)
        encoded[int(cid)] = encode_caption(r[2], tok)
    labels = os.path.join(root, "labels.csv")
    with open(labels, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image_id", "id", "caption", "split"])
        w.writerows(rows)
    enc = os.path.join(root, "encoded_captions.pkl")
    with open(enc, "wb") as f:
        pickle.dump(encoded, f)
    ann = os.path.join(root, "MSR_VTT.json")
    with open(ann, "w") as f:
        json.dump({"annotations": [{"image_id": r[0], "caption": r[2],
                                    "id": r[1]} for r in rows]}, f)
    return dict(videos=vids, labels=labels, encoded=enc, annotations=ann)


def datasets(paths, split="test", num_frames=6, random_state=5):
    """(JAX's CaptionDataset on the DataFrame, the port's on its csv
    table) over ``split``'s videos."""
    jdata, jenc = jds.load_labels(paths["labels"], paths["encoded"])
    pdata, penc = pds.load_labels(paths["labels"], paths["encoded"])
    ids = list(jdata.loc[jdata["split"] == split, "image_id"].unique())
    assert pdata.video_ids(split) == ids
    return (jds.CaptionDataset(paths["videos"], ids, jdata, jenc,
                               num_frames=num_frames,
                               random_state=random_state),
            pds.CaptionDataset(paths["videos"], ids, pdata, penc,
                               num_frames=num_frames,
                               random_state=random_state))


def as_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_batches_equal(jbatches, pbatches, frames_atol=0.0):
    assert len(jbatches) == len(pbatches)
    for jb, pb in zip(jbatches, pbatches):
        assert pb["vid-id"] == jb["vid-id"]
        assert pb["caption-id"] == [int(c) for c in jb["caption-id"]]
        np.testing.assert_array_equal(as_numpy(pb["caption"]),
                                      as_numpy(jb["caption"]))
        got, want = as_numpy(pb["frames"]), as_numpy(jb["frames"])
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=frames_atol)


# ----------------------------------------------------------- video copies

@pytest.fixture(scope="module")
def video(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path_factory.mktemp("vids") / "video0.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    if not w.isOpened():
        pytest.skip("no mp4 codec available")
    base = np.random.default_rng(0).integers(0, 255, size=(48, 64, 3),
                                             dtype=np.uint8)
    for i in range(30):  # tests/test_data.py's clip
        w.write(np.clip(base.astype(np.int32) + i * 5, 0, 255)
                .astype(np.uint8))
    w.release()
    return path


@pytest.mark.parametrize("fn,args", [
    ("get_video_frames", ()), ("get_evenly_sampled_frames", (6,)),
    ("get_evenly_sampled_frames", (7,)), ("get_evenly_sampled_frames2", (6,)),
    ("get_video_frames_with_resize", (0.5, 0.5)),
    ("get_video_frames_with_rgb_to_gray", ()),
    ("get_video_frames_with_downsample", (3,)),
    ("get_video_frames_with_resize_and_downsample", (0.5, 0.75, 2))])
def test_video_handlers_equal_original(video, fn, args):
    got = getattr(pvh, fn)(video, *args)
    want = getattr(jvh, fn)(video, *args)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["sharpen", "hist_eq", "unsharp",
                                    "contrast"])
def test_enhancements_equal_original(video, method):
    frames = jvh.get_video_frames(video)[:3]
    np.testing.assert_array_equal(pvh.enhance_frame_features(frames, method),
                                  jvh.enhance_frame_features(frames, method))


@pytest.mark.parametrize("name,arg", [("uniform", 0.5), ("bins", 5),
                                      ("clustered", 3), ("mse", 10.0),
                                      ("scene", 0.05)])
def test_samplers_equal_original(video, name, arg):
    assert sorted(pfs.SAMPLERS) == sorted(jfs.SAMPLERS)
    np.testing.assert_array_equal(pfs.SAMPLERS[name](video, arg),
                                  jfs.SAMPLERS[name](video, arg))


@pytest.mark.parametrize("module,argv", [
    ("video_handlers", ["--function", "get_evenly_sampled_frames2"]),
    ("video_handlers", ["--function",
                        "get_video_frames_with_resize_and_downsample"]),
    ("frame_sampling", ["--function", "scene", "--hist_threshold", "0.05"]),
    ("frame_sampling", ["--function", "bins"])])
def test_cli_equals_original(video, capsys, module, argv):
    ours = {"video_handlers": pvh, "frame_sampling": pfs}[module]
    theirs = {"video_handlers": jvh, "frame_sampling": jfs}[module]
    got = ours.main(["--video_path", video] + argv)
    out = capsys.readouterr().out
    want = theirs.main(["--video_path", video] + argv)
    np.testing.assert_array_equal(got, want)
    assert out == capsys.readouterr().out


# ------------------------------------------------------ labels and dataset

@pytest.fixture(scope="module")
def tree(tmp_path_factory, video):
    """Two splits; video2 is an mp4 (decoded through OpenCV)."""
    return write_msrvtt(str(tmp_path_factory.mktemp("msrvtt")), n_videos=14,
                        splits=("test", "train"), mp4=("video2",))


def test_load_labels_equals_pandas(tree):
    jdata, jenc = jds.load_labels(tree["labels"], tree["encoded"])
    pdata, penc = pds.load_labels(tree["labels"], tree["encoded"])
    assert penc == jenc
    assert list(pdata.columns) == list(jdata.columns)
    for name in jdata.columns:
        assert pdata.columns[name] == jdata[name].tolist(), name
    assert len(pdata) == len(jdata)
    for split in ("test", "train", "validate"):
        assert pdata.video_ids(split) == list(
            jdata.loc[jdata["split"] == split, "image_id"].unique())
    for vid in jdata["image_id"].unique():
        assert pdata.caption_ids(vid) == list(
            jdata.loc[jdata["image_id"] == vid, "id"])


@pytest.mark.parametrize("random_state", [5, 0, 17])
def test_caption_dataset_items_equal_jax(tree, random_state):
    jds_, pds_ = datasets(tree, random_state=random_state)
    jdf = jds_.data
    ported_df = pds.CaptionDataset(tree["videos"], jds_.vid_ids, jdf,
                                   jds_.encoded_caption_data,
                                   random_state=random_state)
    assert len(pds_) == len(jds_) == 7
    for i in range(len(jds_)):
        want = jds_[i]
        for got in (pds_[i], ported_df[i]):
            assert got["vid-id"] == want["vid-id"]
            assert got["caption-id"] == want["caption-id"]
            np.testing.assert_array_equal(got["caption"], want["caption"])
            np.testing.assert_array_equal(got["frames"], want["frames"])
            assert got["frames"].dtype == np.uint8
        assert pds_.item_meta(i)["caption-id"] == want["caption-id"]


def test_unseeded_caption_choice_follows_numpy_global_state(tree):
    jds_, pds_ = datasets(tree, random_state=None)
    for i in range(len(jds_)):
        np.random.seed(100 + i)
        want = jds_.item_meta(i)["caption-id"]
        np.random.seed(100 + i)
        assert pds_.item_meta(i)["caption-id"] == want


def test_collate_batch_equals_jax(tree):
    jds_, pds_ = datasets(tree)
    for size in (12, 40, 3):  # 3 cuts captions to the bucket
        want = jds.collate_batch([jds_[i] for i in range(4)], size)
        got = pds.collate_batch([pds_[i] for i in range(4)], size)
        assert_batches_equal([want], [got])


def test_npy_clip_frame_choice(tmp_path):
    """The two stride subsamples of load_clip_frames, over clip lengths
    below, at and above the frame count."""
    for n in (3, 6, 7, 14, 40):
        np.save(tmp_path / f"c{n}.npy", np.arange(n, dtype=np.uint8)
                .reshape(n, 1, 1, 1).repeat(2, 1))
        np.testing.assert_array_equal(
            pds.load_clip_frames(str(tmp_path), f"c{n}", 6),
            jds.load_clip_frames(str(tmp_path), f"c{n}", 6))
    with pytest.raises(FileNotFoundError):
        pds.load_clip_frames(str(tmp_path), "missing", 6)


# ---------------------------------------------------------------- loader

def _loaders(tree, **kw):
    jds_, pds_ = datasets(tree)
    return (jds.DeviceLoader(jds_, **kw),
            pds.DeviceLoader(pds_, device="cpu", **kw))


@pytest.mark.parametrize("drop_last", [False, True])
def test_device_loader_preprocessed_batches_equal_jax(tree, drop_last):
    jl, pl = _loaders(tree, batch_size=3, drop_last=drop_last)
    jb, pb = list(jl), list(pl)
    assert len(pb) == len(pl) == len(jl) == (2 if drop_last else 3)
    assert [len(b["vid-id"]) for b in pb] == [3, 3] + ([] if drop_last
                                                      else [1])
    f = pb[0]["frames"]
    assert f.dtype == torch.float32 and f.shape == (3, 6, 224, 224, 3)
    assert pb[0]["caption"].dtype == torch.int32
    assert pb[0]["caption"].shape == (3, 40)
    assert_batches_equal(jb, pb, frames_atol=TOL)
    assert pl.wait_s >= 0.0


def test_device_loader_shuffle_per_epoch_equals_jax(tree):
    jl, pl = _loaders(tree, batch_size=2, shuffle=True, seed=3,
                      preprocess=False)
    orders = []
    for epoch in range(3):
        jb, pb = list(jl), list(pl)
        assert_batches_equal(jb, pb)
        orders.append(tuple(v for b in pb for v in b["vid-id"]))
    assert len(set(orders)) > 1  # the epoch seed advances
    for loader in (jl, pl):
        loader.set_epoch(1)
    again = list(pl)
    assert_batches_equal(list(jl), again)
    assert tuple(v for b in again for v in b["vid-id"]) == orders[1]


def test_device_loader_host_slice_equals_jax(tree):
    for lo, hi in ((0, 2), (2, 4)):
        jl, pl = _loaders(tree, batch_size=4, shuffle=True, seed=1,
                          preprocess=False, drop_last=True,
                          host_slice=(lo, hi))
        jb, pb = list(jl), list(pl)
        assert [len(b["vid-id"]) for b in pb] == [2]
        assert_batches_equal(jb, pb)
    with pytest.raises(ValueError, match="drop_last"):
        pds.DeviceLoader(datasets(tree)[1], 4, host_slice=(0, 2))


def test_device_loader_process_pool_equals_inline(tree):
    """Clips decoded in a 2-worker spawn pool (the mp4 included) give the
    inline batches and JAX's."""
    jl, _ = _loaders(tree, batch_size=3, preprocess=False)
    inline = list(pds.DeviceLoader(datasets(tree)[1], 3, preprocess=False,
                                   device="cpu"))
    with pds.DeviceLoader(datasets(tree)[1], 3, preprocess=False,
                          num_workers=2, device="cpu") as pooled_loader:
        pooled = list(pooled_loader)
        assert pooled_loader._pool is not None
    assert pooled_loader._pool is None
    assert_batches_equal(inline, pooled)
    assert_batches_equal(list(jl), pooled)


def test_device_loader_surfaces_producer_errors(tree, tmp_path):
    _, pds_ = datasets(tree)
    broken = pds.CaptionDataset(str(tmp_path), pds_.vid_ids, pds_.data,
                                pds_.encoded_caption_data)
    with pytest.raises(FileNotFoundError):
        list(pds.DeviceLoader(broken, 2, device="cpu"))


def _rank_mesh(dp: int, index: int):
    """The mesh rank ``index`` of a dp-only process group sees (its
    placement makes no collective, so no group is needed here)."""
    import collections
    from rtvc_tpu_torch.parallel.mesh import Mesh
    return Mesh(collections.OrderedDict(dp=dp, tp=1), torch.device("cpu"),
                {"dp": index, "tp": 0}, {}, None, True)


@pytest.mark.parametrize("preprocess", [False, True])
def test_device_loader_mesh_rows_equal_jax(tree, preprocess):
    """``DeviceLoader(mesh=...)``: each dp rank gets its rows of every
    batch; the ranks' rows together are JAX's dp-sharded global batch."""
    from rtvc_tpu.parallel.mesh import make_mesh as jax_mesh
    jds_, pds_ = datasets(tree)
    kw = dict(shuffle=True, seed=2, drop_last=True, preprocess=preprocess)
    jb = list(jds.DeviceLoader(jds_, 2, mesh=jax_mesh((2, 1)), **kw))
    ranks = [list(pds.DeviceLoader(pds_, 2, mesh=_rank_mesh(2, i), **kw))
             for i in range(2)]
    assert len(ranks[0]) == len(ranks[1]) == len(jb) == len(pds_) // 2 > 1
    for j, b0, b1 in zip(jb, *ranks):
        assert j["frames"].sharding.spec[0] == "dp"
        assert [len(b["vid-id"]) for b in (b0, b1)] == [1, 1]
        whole = {k: (torch.cat([b0[k], b1[k]]) if k in ("frames", "caption")
                     else b0[k] + b1[k]) for k in b0}
        assert_batches_equal([j], [whole], frames_atol=TOL)
    with pytest.raises(ValueError, match="does not split"):
        list(pds.DeviceLoader(pds_, 3, mesh=_rank_mesh(2, 0), **kw))
    from rtvc_tpu_torch.parallel import make_mesh
    with pytest.raises(ValueError, match="one rank of a process group"):
        pds.DeviceLoader(pds_, 4, mesh=make_mesh((2, 1),
                                                 devices=["cpu"] * 2))


def test_preprocess_matches_jax_at_msrvtt_size():
    """The loader's preprocess at MSRVTT's 240x320 frames, against JAX's."""
    from rtvc_tpu.ops.preprocess import clip_preprocess as jax_preprocess
    from rtvc_tpu_torch.ops.preprocess import clip_preprocess
    frames = np.random.default_rng(9).integers(0, 255, size=(4, 240, 320, 3),
                                               dtype=np.uint8)
    got = clip_preprocess(torch.from_numpy(frames)).numpy()
    want = np.asarray(jax_preprocess(jnp.asarray(frames)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_eval_modules_import_without_pandas_or_cv2():
    code = ("import sys\n"
            "for name in ('pandas', 'cv2'):\n"
            "    sys.modules[name] = None\n"
            "import rtvc_tpu_torch.evaluate, rtvc_tpu_torch.inference\n"
            "import rtvc_tpu_torch.pruning, rtvc_tpu_torch.pruning_test\n"
            "import rtvc_tpu_torch.data.dataset, rtvc_tpu_torch.metrics\n"
            "import rtvc_tpu_torch.utils.logging, rtvc_tpu_torch.data\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'flax', 'rtvc_tpu', 'pandas', 'cv2')\n"
            "       and sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
