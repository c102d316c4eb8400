"""coati_tpu: codon-aware statistical sequence aligner in JAX.

A ground-up reimplementation of the capabilities of COATi
(CartwrightLab/coati) for accelerators: batched anti-diagonal wavefront
pair-HMM DP (XLA scan, and a CUDA kernel on NVIDIA GPUs), host-side codecs
and traceback, and data-parallel scaling over device meshes.
"""

__version__ = "0.1.0"
