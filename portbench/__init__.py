"""The benchmark of the PyTorch and CUDA port (`ceph_tpu_torch`): one
run of one cell is `python3 portbench/run.py --workload NAME --seed N
--seconds S --trace 0|1`; see `run.py`."""
