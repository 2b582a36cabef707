"""The sharded plane: fault scripts and the mining plane executed over a
``torch.distributed`` device mesh, one process a rank."""
