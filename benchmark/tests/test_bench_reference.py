"""The float32 reference against the program on the CPU, at a tiny size,
on the benchmark's seeded weights."""

import torch

import tiny
from benchlib import program, seeds, traffic
from reference.common import Precision
from reference.student import Student
from reference.teacher import Teacher


def _student(seed=3):
    cfg = tiny.STUDENT
    values = program.student_values(cfg, seed, "cpu")
    prog = program.student(cfg, values, "cpu")
    ref = Student(cfg, {k: v.float() for k, v in values.items()})
    return cfg, prog, ref


def test_student_encoder_and_decoder_match():
    from rtvc_tpu_torch.ops.preprocess import clip_preprocess
    cfg, prog, ref = _student()
    win = traffic.windows(3, cfg["num_frames"], (224, 224), 11, "cpu")
    with torch.no_grad():
        flat = win.reshape((-1,) + win.shape[2:])
        proc = clip_preprocess(flat).reshape(win.shape[:2] + (224, 224, 3))
        _, mem_p = prog.forward_image_enc(proc)
        mem_r = ref.encode_u8(win)
        assert torch.allclose(mem_p, mem_r, atol=1e-5, rtol=1e-5)
        tok = traffic.captions(3, 7, 3, 7, 160, 5, "cpu")
        lp = prog.forward_decoder(tok, mem_p)
        lr = ref.decoder_logits(tok, mem_r)
        assert torch.allclose(lp, lr, atol=1e-5, rtol=1e-5)


def test_student_greedy_matches_the_program_step():
    from rtvc_tpu_torch.serving import make_caption_step
    cfg, prog, ref = _student(seed=4)
    win = traffic.windows(3, cfg["num_frames"], (224, 224), 12, "cpu")
    rows_p = make_caption_step(prog, max_len=cfg["max_len"])(win)
    with torch.no_grad():
        rows_r = ref.greedy(ref.encode_u8(win), cfg["max_len"])
    assert torch.equal(rows_p.long(), rows_r)


def test_teacher_logits_match():
    cfg = tiny.TEACHER
    values = program.teacher_values(cfg, 5, "cpu")
    prog = program.teacher(cfg, values, "cpu")
    ref = Teacher(cfg, {k: v.float() for k, v in values.items()})
    frames = torch.randn(2, 2, 224, 224, 3)
    caps = traffic.captions(2, 8, 3, 8, 160, 6, "cpu")
    with torch.no_grad():
        lp = prog.forward_output_logits(frames, caps)[0]
        lr = ref.logits(frames, caps)
    assert torch.allclose(lp, lr, atol=1e-4, rtol=1e-4)


def test_train_mode_draws_match_the_program():
    """Dropout and DropPath: the reference draws what the program draws
    from the same generator, so the train-mode logits agree."""
    cfg, prog, ref = _student(seed=6)
    prog.train()
    ref.train = True
    frames = torch.randn(2, cfg["num_frames"], 224, 224, 3)
    caps = traffic.captions(2, 7, 3, 7, 160, 7, "cpu")
    g1, g2 = seeds.step_generator(9, 0), seeds.step_generator(9, 0)
    with torch.no_grad():
        out = prog.distill_forward(frames, caps, generator=g1)["logits"]
        mem = ref.encode(frames, g2)
        lr = ref.decoder_logits(caps, mem, g2)
    assert torch.allclose(out, lr, atol=1e-4, rtol=1e-4)
    assert torch.equal(torch.rand(3, generator=g1),
                       torch.rand(3, generator=g2))


def test_fp8_precision_rounds():
    p = Precision("fp8")
    x = torch.linspace(-3, 3, 101)
    y = p(x)
    assert not torch.equal(x, y)
    assert float((x - y).abs().max()) < 0.07 * 3
    assert torch.equal(Precision()(x), x)
