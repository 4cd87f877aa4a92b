"""Multi-GPU serving over `torch.distributed`: the rank mesh (`mesh.py`),
Megatron tensor parallelism of the Qwen LM as shard functions
(`shardings.py`), process-group start-up across hosts (`multihost.py`),
and the leader/follower mechanism by which the ranks of a tensor-parallel
row serve one engine from rank 0 (`worker.py`).  Port of
`sparktts_tpu/parallel/`."""
