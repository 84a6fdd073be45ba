"""Kernel backends: oracle (numpy), XLA (lax.scan), Pallas/Triton (GPU)."""
