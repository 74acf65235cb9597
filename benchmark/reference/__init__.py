"""Plain PyTorch reference of what the benchmark's cells run.

Written from the published descriptions (ResNet-50: He et al. 2015,
arXiv 1512.03385; ViT-B/16: Dosovitskiy et al. 2020, arXiv 2010.11929;
BYOL: Grill et al. 2020, arXiv 2006.07733, with LARS, the cosine EMA and
the augmentation of its appendix) in float32 with TF32 off.  Nothing here
imports the system under test, JAX, or the JAX package: the weights are a
dict ``{name: tensor}`` that the benchmark makes from the seed, and the
names are the parameter names of the served and trained network, so the
same dict feeds both sides.

``precision.Cast`` is the one place the arithmetic's precision is chosen:
``FP32`` computes everything in float32; ``FP8`` rounds every operand of a
convolution or matrix product to float8 e4m3 (scaled per tensor), the
control that a check has to refuse.
"""
