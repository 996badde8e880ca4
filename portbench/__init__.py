"""The benchmark of the PyTorch and CUDA port (``sparsefusion_tpu_torch``)
on NVIDIA H100 cards: ``python3 -m portbench.run --workload <name>
--seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json`` once (``portbench/run.py``)."""
