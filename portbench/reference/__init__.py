"""The plain reference: FLUX.1 text-to-image in float32 PyTorch, written from the
published descriptions (BFL's ``flux`` package, HF's T5 and CLIP, A1111's emphasis
grammar), with no kernel, compile, cache or batching. It imports nothing of the
program under test and takes nothing it made: weights are drawn again from the run's
seed (``portbench.weights``), calibration scales and noise are worked out again.

Quantization is emulated where the configuration states it: a quantized operand is
rounded to its grid and multiplied in float32. ``Precision`` names the grid of each
model; the configuration's is the reference, one grid lower is the control.
"""
