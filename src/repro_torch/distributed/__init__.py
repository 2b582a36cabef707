"""The sharded plane: fault scripts and the mining plane executed over a
``torch.distributed`` device mesh, one process a rank; and the parallel
training plane's collectives (``collectives.py``) and sharding rules
(``meshes.py``)."""
