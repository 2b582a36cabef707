"""Mining backends: algorithm formulations behind one protocol.

The horizontal (Apriori) plane lives in :mod:`repro_torch.pipeline`; this
package adds the vertical (Eclat) formulation, the cost-model
auto-selector that picks between them per dataset, and the out-of-core
SON plane that partitions corpora larger than device memory into
disk-resident chunks with crash-safe checkpointed resume.
"""
from repro_torch.mining.backend import (ALGORITHMS, MiningBackend, make_miner,
                                        resolve_algorithm)
from repro_torch.mining.eclat.miner import EclatMiner
from repro_torch.mining.select import (AlgorithmChoice, AlgorithmCostModel,
                                       local_min_support, partition_stats,
                                       select_algorithm,
                                       select_partition_algorithm)
from repro_torch.mining.son import SONConfig, SONKilled, SONMiner

__all__ = [
    "ALGORITHMS", "AlgorithmChoice", "AlgorithmCostModel", "EclatMiner",
    "MiningBackend", "SONConfig", "SONKilled", "SONMiner",
    "local_min_support", "make_miner", "partition_stats",
    "resolve_algorithm", "select_algorithm", "select_partition_algorithm",
]
