"""The benchmark's operation and byte counts against values worked out
by hand."""

import json
from pathlib import Path

from benchlib import work

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
STUDENT = json.loads((CONFIGS / "student-tinyvit21m-d576.json").read_text())
DISTILL = json.loads((CONFIGS / "git-large-msrvtt-distill.json").read_text())


def test_tinyvit_stage_1_by_hand():
    # PatchMerging 96 -> 192 at 56x56 -> 28x28:
    #   1x1: 3136*96*192 = 57,802,752; dw3x3 s2: 784*192*9 = 1,354,752;
    #   1x1: 784*192*192 = 28,901,376                    -> 88,058,880 MACs
    # a block (C 192, 784 tokens, 7x7 windows, N 49, MLP 768):
    #   qkv 784*192*576 = 86,704,128; Q.K and P.V 2*784*49*192 = 14,751,744;
    #   proj 784*192*192 = 28,901,376; local dw3x3 784*192*9 = 1,354,752;
    #   MLP 2*784*192*768 = 231,211,008                 -> 362,923,008 MACs
    # two blocks: 725,846,016; the stage 813,904,896 MACs = 1,627,809,792
    assert work.tinyvit_stage_flops(STUDENT["encoder"], 1) == 1_627_809_792


def test_decode_token_by_hand():
    # d 576, FFN 1024, 6 memory tokens, vocab 30522, token at position 4:
    # a layer: 4*576^2 = 1,327,104; 2*5*576 = 5,760; 2*576^2 = 663,552;
    #   2*6*576 = 6,912; 2*576*1024 = 1,179,648        -> 3,182,976 MACs
    # two layers 6,365,952 + vocab 576*30522 = 17,580,672
    #   -> 23,946,624 MACs = 47,893,248 FLOPs
    assert work.decoder_token_flops(STUDENT["decoder"], 6, 4) == 47_893_248


def test_k4_launch_by_hand():
    # the teacher's joint attention: B 8, H 12, L 1582 (6*257 + 40), D 64,
    # prefix 1542: rows < 1542 see 1542 keys, row r >= 1542 sees r + 1;
    # pairs a head = 1542*1542 + (1543 + ... + 1582) = 2,377,764 + 62,500
    #   = 2,440,264; operations 4*64*12*8*2,440,264 = 59,971,928,064
    # bytes: q, o, k, v each 8*12*1582*64*2 = 19,439,616 -> 77,758,464
    nbytes, flops = work.flash_work(8, 12, 1582, 64, 1542)
    assert flops == 59_971_928_064
    assert nbytes == 77_758_464
    seconds, kind = work.bound_s(nbytes, flops)
    assert kind == "operations"
    assert abs(seconds - 59_971_928_064 / 989e12) < 1e-15


def test_k1_launch_by_hand():
    # stage 1 at batch 8: 768 windows, 6 heads, 49 tokens, 32 wide, bf16;
    # bias [6, 49, 49] float32
    nbytes, flops = work.window_work(768, 6, 49, 32)
    assert nbytes == 4 * 768 * 6 * 49 * 32 * 2 + 6 * 49 * 49 * 4
    assert flops == 4 * 768 * 6 * 49 * 49 * 32


def test_whole_models_are_of_the_published_size():
    # TinyViT-21M at 224: 4.3-4.4 GMACs an image; CLIP ViT-L/14: 77-81
    assert 8.4e9 < work.tinyvit_image_flops(STUDENT["encoder"]) < 8.9e9
    assert 1.5e11 < work.clip_image_flops(DISTILL["teacher"]["clip"]) < 1.65e11
    step = work.train_step_flops(DISTILL)
    assert 8e12 < step < 1.2e13
