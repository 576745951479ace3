"""Plain float32 references of the benchmark's architectures.

Written from the published descriptions in plain PyTorch; they import
nothing of the program (``repro_torch``), of the JAX package or of JAX.
"""
