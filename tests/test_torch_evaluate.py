"""The port's evaluation path against the JAX package's: ``train.evaluate``,
``evaluate.evaluate_checkpoint`` (and its CLI), ``inference.inference``.

The tiny student of tests/test_models.py, built for the loader's 224-pixel
frames with its vocab projection scaled up (tests/test_torch_beam.py;
for the greedy decode its cross-attention too, :func:`lively`) carries
the same weights on both sides (the weight bridge; the port's
``evaluate_checkpoint`` reads them from a checkpoint the port wrote). Each
side decodes an MSRVTT-format tree of 11 clips (tests/test_torch_data.py's
``write_msrvtt``) through its own ``DeviceLoader`` in batches of 4, 4 and
3, JAX's at ``default_matmul_precision("highest")``, greedy and with beam
2, to ``max_len`` 45 (the 40-token bucket + 5). Random weights give
near-flat logits, so each JAX decode is first replayed step by step and
every choice asserted to win by more than 1e-3. Then the token rows, the
texts, the per-batch corpus BLEU-4, the COCO scores (annotations present
and absent), the run files and the printed ``GT:``/``Pred:`` lines must be
equal.
"""

import dataclasses
import json
import os
import time

import jax
import numpy as np
import pytest

from rtvc_tpu import config as jconfig
from rtvc_tpu import decode as jdecode
from rtvc_tpu import evaluate as jevaluate
from rtvc_tpu import inference as jinference
from rtvc_tpu import metrics as jmetrics
from rtvc_tpu import train as jtrain
from rtvc_tpu.tokenization import BertWordPieceTokenizer as JaxTokenizer
from rtvc_tpu.utils.logging import RunLogger as JaxRunLogger
from rtvc_tpu_torch import config as pconfig
from rtvc_tpu_torch import decode as pdecode
from rtvc_tpu_torch import evaluate as pevaluate
from rtvc_tpu_torch import inference as pinference
from rtvc_tpu_torch import metrics as pmetrics
from rtvc_tpu_torch import serving
from rtvc_tpu_torch import train as ptrain
from rtvc_tpu_torch.data import dataset as pds
from rtvc_tpu_torch.data import io
from rtvc_tpu_torch.models.student import random_init_
from rtvc_tpu_torch.tokenization import BertWordPieceTokenizer
from rtvc_tpu_torch.utils.logging import RunLogger

from test_torch_beam import (assert_jax_beam_margins,
                             assert_jax_greedy_margins, scaled)
from test_torch_data import datasets, write_msrvtt
from test_torch_models import FRAMES, jax_student, port_student

import torch

CROP = 224
BATCH = 4
MAX_LEN = 45  # caption bucket 40 + max_len_extra 5


def lively(variables):
    """The variables with the vocab projection ×10 (scaled) and the
    cross-attention's output projection ×10: at the init's scales every
    clip decodes to the same token, repeated, which would leave a fault in
    the order of the rows unseen; with these the rows depend on the
    clip."""
    params = dict(scaled(variables)["params"])
    for name in ("decoder_layer_0", "decoder_layer_1"):
        layer = dict(params[name])
        cross = dict(layer["cross_attn"])
        cross["out_proj"] = {k: v * 10.0 if k == "kernel" else v
                             for k, v in cross["out_proj"].items()}
        layer["cross_attn"] = cross
        params[name] = layer
    return dict(variables, params=params)


@pytest.fixture(scope="module")
def pairs():
    """(JAX model, variables, port student) by beam width: the greedy
    decode on :func:`lively` weights; the beam on the vocab-scaled ones,
    where its candidate tables keep the margin (with the cross-attention
    ×10 two of them come within 3e-5)."""
    jmodel, variables = jax_student(size=CROP)
    out = {}
    for beam, v in ((0, lively(variables)), (2, scaled(variables))):
        out[beam] = (jmodel, v, port_student(v, input_size=CROP))
    return out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_msrvtt(str(tmp_path_factory.mktemp("msrvtt")), n_videos=11,
                        seed=4)


@pytest.fixture(scope="module")
def ckpts(pairs, tmp_path_factory):
    """Each port student's weights in a checkpoint the port wrote."""
    out = {}
    for beam, (_, _, port) in pairs.items():
        out[beam] = str(tmp_path_factory.mktemp("run") / "ckpt_00")
        io.save_checkpoint(out[beam], {"state_dict": port.state_dict()})
    return out


def fresh_port_student():
    """A tiny port student of the pair's shape, other (random) weights."""
    jmodel, variables = jax_student(size=CROP)
    return random_init_(port_student(variables, input_size=CROP),
                        torch.Generator().manual_seed(11)).eval()


def loaders(tree):
    jds_, pds_ = datasets(tree, num_frames=FRAMES)
    from rtvc_tpu.data.dataset import DeviceLoader as JaxLoader
    return (JaxLoader(jds_, BATCH),
            pds.DeviceLoader(pds_, BATCH, device="cpu"))


class Recorder:
    """Wraps a decode function and keeps every result as numpy."""

    def __init__(self, fn):
        self.fn, self.rows = fn, []

    def __call__(self, *a, **k):
        out = self.fn(*a, **k)
        self.rows.append(np.asarray(out.numpy() if isinstance(
            out, torch.Tensor) else out))
        return out


def record(monkeypatch, beam: int):
    name = "student_beam" if beam else "student_greedy"
    jrec, prec = (Recorder(getattr(jdecode, name)),
                  Recorder(getattr(pdecode, name)))
    monkeypatch.setattr(jdecode, name, jrec)
    monkeypatch.setattr(pdecode, name, prec)
    return jrec, prec


def assert_margins(jmodel, variables, jloader, beam: int, max_len: int):
    """Replay JAX's decode of every batch and return its rows."""
    out = []
    for batch in jloader:
        frames = np.asarray(batch["frames"])
        out.append(assert_jax_beam_margins(jmodel, variables, frames, beam,
                                           max_len) if beam else
                   assert_jax_greedy_margins(jmodel, variables, frames,
                                             max_len))
    return out


@pytest.fixture(scope="module")
def jax_runs(pairs, tree, tmp_path_factory):
    """JAX's evaluate per decode mode: (replayed rows, decoded rows, mean
    BLEU-4, outputs, run file, scalar records), annotations present."""
    annotations = jmetrics.load_coco_annotations(tree["annotations"])
    runs = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(time, "time", lambda: 1234.5)
        for beam in (0, 2):
            jmodel, variables, _ = pairs[beam]
            jloader, _ = loaders(tree)
            replay = assert_margins(jmodel, variables, jloader, beam,
                                    MAX_LEN)
            jrec, _ = record(mp, beam)
            run_dir = str(tmp_path_factory.mktemp(f"jax_run{beam}"))
            logger = JaxRunLogger(run_dir, "eval", config_dump={"beam": beam})
            with jax.default_matmul_precision("highest"):
                bleu, outputs = jtrain.evaluate(
                    jmodel, variables, jloader, JaxTokenizer(), logger,
                    epoch=3, split="Validation", annotations=annotations,
                    verbose=True, beam_size=beam)
            mp.undo()
            mp.setattr(time, "time", lambda: 1234.5)
            runs[beam] = dict(replay=replay, rows=jrec.rows, bleu=bleu,
                              outputs=outputs, run_dir=run_dir)
    finally:
        mp.undo()
    return runs


@pytest.mark.parametrize("beam", [0, 2])
def test_evaluate_equals_jax(pairs, tree, jax_runs, tmp_path, monkeypatch,
                             capsys, beam):
    want = jax_runs[beam]
    for replay, rows in zip(want["replay"], want["rows"]):
        np.testing.assert_array_equal(rows, replay)
    _, ploader = loaders(tree)
    _, prec = record(monkeypatch, beam)
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    logger = RunLogger(str(tmp_path), "eval", config_dump={"beam": beam})
    annotations = pmetrics.load_coco_annotations(tree["annotations"])
    bleu, outputs = ptrain.evaluate(
        pairs[beam][2], ploader, BertWordPieceTokenizer(), logger, epoch=3,
        split="Validation", annotations=annotations, verbose=True,
        beam_size=beam)
    assert [r.shape for r in prec.rows] == [
        (n, MAX_LEN + (0 if beam else 1)) for n in (4, 4, 3)]
    for got, rows in zip(prec.rows, want["rows"]):
        np.testing.assert_array_equal(got, rows)
    assert outputs == want["outputs"]
    assert bleu == want["bleu"]
    assert [o["image_id"] for o in outputs] == datasets(tree)[1].vid_ids
    if beam == 0:  # lively weights: the clips differ
        assert len({o["caption"] for o in outputs}) > 1
    for name in ("_results_and_metrics.txt", "scalars.jsonl"):
        assert ((tmp_path / name).read_text()
                == open(os.path.join(want["run_dir"], name)).read())
    assert "Student Predictions" in capsys.readouterr().out


def test_make_eval_step_is_the_greedy_decode(pairs):
    port = pairs[0][2]
    frames = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, FRAMES, CROP, CROP, 3)).astype(np.float32))
    step = ptrain.make_eval_step(port, 9)
    np.testing.assert_array_equal(
        step(frames).numpy(),
        pdecode.student_greedy(port, frames, max_len=9).numpy())


def test_null_logger_accepts_the_logger_calls():
    logger = ptrain._NullLogger()
    logger.write("x")
    logger.log_scalars(0, {"a": 1.0})
    logger.log_epoch_transcript("Test", 0, [["a"]], ["b"], 1.0)
    logger.finish()


@pytest.mark.parametrize("with_annotations", [True, False])
@pytest.mark.parametrize("beam", [0, 2])
def test_evaluate_checkpoint_equals_jax(pairs, tree, ckpts, jax_runs, beam,
                                        with_annotations):
    """The port reads the weights from its own checkpoint into a student
    that held others; JAX gets the same weights as variables."""
    jmodel, variables, port = pairs[beam]
    annotations = (jmetrics.load_coco_annotations(tree["annotations"])
                   if with_annotations else None)
    jloader, ploader = loaders(tree)
    with jax.default_matmul_precision("highest"):
        want = jevaluate.evaluate_checkpoint(
            jconfig.cfg, jloader, JaxTokenizer(), student=jmodel,
            variables=variables, beam_size=beam, annotations=annotations)
    got = pevaluate.evaluate_checkpoint(
        pconfig.cfg, ploader, BertWordPieceTokenizer(), ckpt=ckpts[beam],
        student=fresh_port_student(), beam_size=beam,
        annotations=annotations, device="cpu")
    assert got == want
    assert got[1] == jax_runs[beam]["outputs"]
    keys = {"corpus_bleu4"} | ({"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
                                "METEOR", "ROUGE_L", "CIDEr"}
                               if with_annotations else set())
    assert set(got[0]) == keys
    # a student given without a checkpoint is used as it is
    _, ploader = loaders(tree)
    assert pevaluate.evaluate_checkpoint(
        pconfig.cfg, ploader, BertWordPieceTokenizer(), student=port,
        beam_size=beam, annotations=annotations, device="cpu") == want


def test_evaluate_checkpoint_resolves_run_name(pairs, tree, ckpts,
                                               tmp_path):
    config = dataclasses.replace(pconfig.cfg, logger=pconfig.LoggerConfig(
        save_dir=str(tmp_path)))
    with pytest.raises(FileNotFoundError):
        pevaluate.resolve_checkpoint(config, "nope", None)
    with pytest.raises(ValueError):
        pevaluate.resolve_checkpoint(config, None, None)
    run = tmp_path / "run" / "r1"
    run.mkdir(parents=True)
    io.save_checkpoint(str(run / "ckpt_01"),
                       io.restore_checkpoint(ckpts[0]))
    assert pevaluate.resolve_checkpoint(config, "r1", None) == str(
        run / "ckpt_01")
    _, ploader = loaders(tree)
    got = pevaluate.evaluate_checkpoint(
        config, ploader, BertWordPieceTokenizer(), run_name="r1",
        student=fresh_port_student(), device="cpu")
    _, ploader = loaders(tree)
    assert got == pevaluate.evaluate_checkpoint(
        config, ploader, BertWordPieceTokenizer(), student=pairs[0][2],
        device="cpu")


def _cli_config(tree, tmp_path):
    return dataclasses.replace(
        pconfig.cfg,
        data=dataclasses.replace(
            pconfig.cfg.data, videos_path=tree["videos"],
            captions_path=tree["labels"], encoded_caption_ids=tree["encoded"],
            annotation_path=tree["annotations"], num_frames=FRAMES),
        logger=pconfig.LoggerConfig(save_dir=str(tmp_path)),
        train=dataclasses.replace(pconfig.cfg.train, batch_size=BATCH))


@pytest.fixture
def cli(tree, tmp_path, monkeypatch):
    """The CLIs on a config pointing at the tree, with the tiny student in
    place of the full-size one ``build_serving_student`` would build."""
    config = _cli_config(tree, tmp_path)
    built = []

    def build(ckpt=None, device="cuda", config=None):
        assert device == "cpu"
        built.append(ckpt)
        return serving.load_student_weights(fresh_port_student(), ckpt)

    for mod in (pevaluate, pinference):
        monkeypatch.setattr(mod, "default_cfg", config)
    monkeypatch.setattr(serving, "build_serving_student", build)
    return config, built


@pytest.mark.parametrize("beam", [0, 2])
def test_evaluate_cli_writes_scores_and_preds(tree, ckpts, cli, jax_runs,
                                              tmp_path, capsys, beam):
    out = str(tmp_path / "scores.json")
    argv = ["--ckpt", ckpts[beam], "--out", out, "--device", "cpu"]
    pevaluate.main(argv + (["--beam", str(beam)] if beam else []))
    assert cli[1] == [ckpts[beam]]
    scores = json.loads(open(out).read())
    preds = json.loads(open(out + ".preds.json").read())
    assert preds == jax_runs[beam]["outputs"]
    annotations = pmetrics.load_coco_annotations(tree["annotations"])
    want = {"corpus_bleu4": jax_runs[beam]["bleu"]}
    want.update({k: v * 100 for k, v in pmetrics.evaluate_captions(
        preds, annotations).items()})
    assert scores == want
    assert json.loads(capsys.readouterr().out.strip()) == scores


def test_evaluate_cli_run_name_and_missing_files(tree, ckpts, cli, tmp_path,
                                                 capsys):
    config, built = cli
    ckpt = ckpts[0]
    run = tmp_path / "run" / "r2"
    run.mkdir(parents=True)
    io.save_checkpoint(str(run / "ckpt_00"), io.restore_checkpoint(ckpt))
    pevaluate.main(["r2", "--device", "cpu", "--annotations",
                    tree["annotations"]])
    assert built == [str(run / "ckpt_00")]
    assert "Bleu_4" in json.loads(capsys.readouterr().out.strip())
    with pytest.raises(SystemExit):
        pevaluate.main(["--ckpt", ckpt, "--device", "cpu", "--annotations",
                        str(tmp_path / "missing.json")])
    with pytest.raises(SystemExit):
        pevaluate.main(["--device", "cpu"])


@pytest.mark.parametrize("beam", [0, 2])
def test_inference_prints_equal_jax(pairs, tree, capsys, beam):
    jmodel, variables, port = pairs[beam]
    jloader, ploader = loaders(tree)
    first = np.asarray(next(iter(jloader))["frames"])
    if beam:
        assert_jax_beam_margins(jmodel, variables, first, beam, 25)
    else:
        assert_jax_greedy_margins(jmodel, variables, first, 25)
    jloader, _ = loaders(tree)
    with jax.default_matmul_precision("highest"):
        want = jinference.inference(jconfig.cfg, jloader, JaxTokenizer(),
                                    "run", student=jmodel,
                                    variables=variables, beam_size=beam)
    jout = capsys.readouterr().out
    got = pinference.inference(pconfig.cfg, ploader, BertWordPieceTokenizer(),
                               "run", student=port, beam_size=beam)
    out = capsys.readouterr().out
    assert got == want
    assert out == jout
    assert out.count("GT:   ") == out.count("Pred: ") == BATCH


def test_inference_cli_loads_the_runs_newest_checkpoint(pairs, tree, ckpts,
                                                        cli, tmp_path,
                                                        capsys):
    config, built = cli
    run = tmp_path / "run" / "r3"
    run.mkdir(parents=True)
    io.save_checkpoint(str(run / "ckpt_00"), io.restore_checkpoint(ckpts[0]))
    pinference.main(["r3", "--device", "cpu"])
    assert built == [str(run / "ckpt_00")]
    out = capsys.readouterr().out
    _, ploader = loaders(tree)
    pinference.inference(config, ploader, BertWordPieceTokenizer(), "r3",
                         student=pairs[0][2])
    assert out == capsys.readouterr().out
