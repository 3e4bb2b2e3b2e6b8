"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one
command runs one cell of ``BENCHMARK.json`` and prints one JSON line
(see ``portbench/README.md``)."""
