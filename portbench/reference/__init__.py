"""Plain references of what the benchmark's cells compute, in plain PyTorch.

Nothing here imports the port or the JAX package, and nothing takes what
the port made: each function starts from the inputs the harness made from
the seed.  ``precision="float64"`` is the reference; ``precision="tf32"``
is its control, the same arithmetic with every product's operands rounded
to TF32 and accumulated in float32, which is what a tensor-core matrix
product does with float32 inputs.
"""
