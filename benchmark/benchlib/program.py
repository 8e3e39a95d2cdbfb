"""The program's models, built from a configuration file: each function
here makes the program's own modules at the configuration's sizes and
fills their parameters with the benchmark's seeded weights
(:mod:`benchlib.weights`); the reference gets the same values.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import weights
from reference import student as ref_student
from reference import teacher as ref_teacher

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg: dict) -> torch.dtype:
    return DTYPES[cfg["dtype"]]


def student_values(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return weights.make(ref_student.param_spec(cfg), seed, device,
                        dtype_of(cfg))


def teacher_values(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return weights.make(ref_teacher.param_spec(cfg), seed, device,
                        dtype_of(cfg))


def student(cfg: dict, values: Dict[str, torch.Tensor], device,
            dtype: torch.dtype = None):
    """``StudentCandidateV1`` at ``cfg``'s sizes, in ``dtype`` (default
    ``cfg["dtype"]``), eval mode, with ``values`` loaded, made on
    ``device`` directly."""
    from rtvc_tpu_torch.config import TinyViTConfig
    from rtvc_tpu_torch.models.student import StudentCandidateV1

    enc, dec, heads = cfg["encoder"], cfg["decoder"], cfg["distill_heads"]
    encoder = TinyViTConfig(
        embed_dims=tuple(enc["embed_dims"]), depths=tuple(enc["depths"]),
        num_heads=tuple(enc["num_heads"]),
        window_sizes=tuple(enc["window_sizes"]), mlp_ratio=enc["mlp_ratio"],
        mbconv_expand_ratio=enc["mbconv_expand_ratio"],
        drop_path_rate=enc["drop_path_rate"], dropout=enc["dropout"],
        gelu_approximate=enc["gelu_approximate"])
    with torch.device(device):
        model = StudentCandidateV1(
            d_model=dec["d_model"], n_head=dec["n_head"],
            d_ffn=dec["d_ffn"], dropout=dec["dropout"],
            num_decoder_layers=dec["num_decoder_layers"],
            vocab_size=dec["vocab_size"], cls_token_id=dec["cls_token_id"],
            sep_token_id=dec["sep_token_id"],
            max_pos_len=dec["max_pos_len"], encoder_config=encoder,
            input_size=enc["input_size"], num_frames=cfg["num_frames"],
            teacher_visual_dim=heads["teacher_visual_dim"],
            teacher_num_tokens=heads["teacher_num_tokens"],
            teacher_hidden=heads["teacher_hidden"])
    model = model.to(device, dtype or dtype_of(cfg))
    weights.load_into(model, values)
    return model.eval()


def teacher(cfg: dict, values: Dict[str, torch.Tensor], device):
    """``GITTeacher`` at ``cfg["teacher"]``'s sizes in ``cfg["dtype"]``,
    made on ``device`` directly, with ``values`` loaded."""
    from rtvc_tpu_torch.config import CLIPViTConfig, GITConfig
    from rtvc_tpu_torch.models.git_teacher import GITTeacher

    t, c = cfg["teacher"], cfg["teacher"]["clip"]
    dtype = dtype_of(cfg)
    git = GITConfig(
        vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
        num_layers=t["num_layers"], attention_heads=t["attention_heads"],
        feedforward_size=t["feedforward_size"],
        visual_feature_size=t["visual_feature_size"],
        max_caption_length=t["max_caption_length"],
        num_image_with_embedding=t["num_image_with_embedding"],
        clip=CLIPViTConfig(image_size=c["image_size"],
                           patch_size=c["patch_size"], width=c["width"],
                           layers=c["layers"], heads=c["heads"],
                           dtype=dtype),
        dtype=dtype)
    with torch.device(device):
        model = GITTeacher(git)
    model = model.to(device, dtype)
    weights.load_into(model, values)
    return model.eval()


def tokenizer():
    from rtvc_tpu_torch.tokenization import BertWordPieceTokenizer
    return BertWordPieceTokenizer()
