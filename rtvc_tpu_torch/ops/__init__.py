"""Ops of the caption step: preprocess, attention (K1), LayerNorm (K2),
int8 quantization and the weight-only int8 GEMV (K3)."""
