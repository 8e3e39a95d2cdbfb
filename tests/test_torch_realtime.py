"""The port's real-time loop (rtvc_tpu_torch.real_time_inference) against
the JAX package's.

``shrink_frame`` gives JAX's pixels at every orientation and size;
``StreamingCaptioner.caption`` gives the text of JAX's captioner and of
the port's own caption step on the same 6-frame windows and weights (the
tiny student of tests/test_models.py for 224-pixel frames, float32, its
vocab projection scaled up, with the JAX replay's margins asserted first,
tests/test_torch_beam.py); and a headless ``run_realtime`` captions a
synthetic ``mp4v`` clip on the CPU, as tests/test_entrypoints.py drives
JAX's.
"""

import threading

import numpy as np
import pytest
import torch

from rtvc_tpu import real_time_inference as jrt
from rtvc_tpu.tokenization import BertWordPieceTokenizer as JaxTokenizer
from rtvc_tpu_torch import real_time_inference as rt
from rtvc_tpu_torch.serving import make_caption_step
from rtvc_tpu_torch.tokenization import BertWordPieceTokenizer

from test_torch_beam import assert_jax_greedy_margins, jax_preprocessed, scaled
from test_torch_models import jax_student, port_student

CROP = 224


def test_constants_equal_jax():
    assert (rt.WINDOW, rt.MAX_LEN, rt.FRAME_KEEP_EVERY) == (
        jrt.WINDOW, jrt.MAX_LEN, jrt.FRAME_KEEP_EVERY)


@pytest.mark.parametrize("shape", [(480, 640, 3), (640, 480, 3),
                                   (180, 240, 3), (224, 300, 3),
                                   (1080, 1920, 3), (225, 225, 3)])
def test_shrink_frame_is_pixel_identical_to_jax(shape):
    pytest.importorskip("cv2")
    frame = np.random.default_rng(sum(shape)).integers(
        0, 255, size=shape, dtype=np.uint8)
    got, want = rt.shrink_frame(frame), jrt.shrink_frame(frame)
    assert got.shape == want.shape
    if min(shape[:2]) >= 224:
        assert got.shape == (224, 224, 3)
    np.testing.assert_array_equal(got, want)


def test_latest_slot_keeps_the_newest():
    slot = rt.LatestSlot()
    assert slot.get(timeout=0.01) is None
    slot.put(1)
    slot.put(2)
    assert slot.get() == 2 and slot.get(timeout=0.01) is None
    got = []
    t = threading.Thread(target=lambda: got.append(slot.get(timeout=5)))
    t.start()
    slot.put(3)
    t.join(10)
    assert got == [3]
    slot.close()
    assert slot.get() is None


@pytest.fixture(scope="module")
def students():
    jmodel, variables = jax_student(size=CROP)
    variables = scaled(variables)
    return jmodel, variables, port_student(variables, input_size=CROP)


def _windows(n: int = 2, seed: int = 9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, size=(rt.WINDOW, 72, 96, 3), dtype=np.uint8)
            for _ in range(n)]


def test_streaming_captioner_equals_jax_and_the_step(students):
    """One window at a time, greedy, the whole row decoded (no SEP
    truncation), as JAX's captioner does."""
    import jax

    jmodel, variables, port = students
    wins = _windows()
    # the batch-of-2 replay runs at least as many steps as either solo run
    assert_jax_greedy_margins(
        jmodel, variables, jax_preprocessed(np.stack(wins), CROP), rt.MAX_LEN)
    with jax.default_matmul_precision("highest"):
        jcap = jrt.StreamingCaptioner(jmodel, variables, JaxTokenizer(),
                                      frame_shape=wins[0].shape[1:])
        want = [jcap.caption(w) for w in wins]
    tok = BertWordPieceTokenizer()
    cap = rt.StreamingCaptioner(port, tok, frame_shape=wins[0].shape[1:])
    got = [cap.caption(w) for w in wins]
    step = make_caption_step(port, max_len=rt.MAX_LEN)
    direct = [tok.decode(step(torch.from_numpy(w[None]))[0].numpy(),
                         skip_special_tokens=True) for w in wins]
    assert got == want == direct
    assert all(want)  # not trivially equal: every caption has text
    assert len(cap.timer.durations) == len(wins)
    summary = cap.timer.summary()
    assert summary["caption_p50_s"] > 0


def test_run_realtime_headless(students, tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "stream.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 64))
    if not w.isOpened():
        pytest.skip("no mp4 codec")
    rng = np.random.default_rng(0)
    for _ in range(120):
        w.write(rng.integers(0, 255, size=(64, 64, 3), dtype=np.uint8))
    w.release()
    stats = rt.run_realtime(source=path, student=students[2],
                            tokenizer=BertWordPieceTokenizer(),
                            display=False, max_captions=2, max_seconds=60,
                            device="cpu")
    assert stats["captions"] >= 1
    assert stats["caption_p50_s"] > 0 and stats["source_fps"] > 0


def test_step_timer_matches_jax_summary():
    """StepTimer records one duration a stop, skips the warm-up call in its
    summary and reports the keys of JAX's; a CPU result needs no sync."""
    from rtvc_tpu.utils.profiling import StepTimer as JaxTimer
    from rtvc_tpu_torch.utils.profiling import StepTimer

    timer = StepTimer("step")
    for _ in range(3):
        with timer.measure():
            pass
    timer.start()
    assert timer.stop(sync_on={"rows": [torch.zeros(2)]}) >= 0
    assert len(timer.durations) == 4
    jtimer = JaxTimer("step")
    jtimer.durations = list(timer.durations)
    assert timer.summary() == jtimer.summary()
    assert timer.summary(skip_warmup=0)["step_min_s"] == min(timer.durations)
