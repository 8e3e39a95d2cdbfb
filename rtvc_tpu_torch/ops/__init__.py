"""Ops of the port: preprocess, attention (K1, K4, K5, K8), LayerNorm (K2,
K6), int8 quantization and GEMMs (K3, K7), the depthwise 3x3 weight
gradient (K9), and the train step's dropout draws."""
