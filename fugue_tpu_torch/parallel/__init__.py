"""Multi-device scale-out over ``torch.distributed``: process bootstrap,
device meshes and the sharded drivers (the port of ``fugue_tpu/parallel``)."""

from .distributed import (
    DistributedConfig,
    config_from_env,
    flat_axis_index,
    initialize_distributed,
    make_hybrid_mesh,
    make_pod_chain_mesh,
)
from .mesh import (
    CHAIN_AXIS,
    DATA_AXIS,
    chain_sharding,
    make_chain_data_mesh,
    make_chain_mesh,
    replicated,
)
from .sharded import (
    sharded_abc_rejection,
    sharded_chees_chain,
    sharded_ess_chain,
    sharded_gibbs_chain,
    sharded_hmc_chain,
    sharded_nuts_chain,
    sharded_pt_chain,
    sharded_smc,
    sharded_vi,
)

__all__ = [
    "CHAIN_AXIS",
    "DATA_AXIS",
    "DistributedConfig",
    "chain_sharding",
    "config_from_env",
    "flat_axis_index",
    "initialize_distributed",
    "make_chain_data_mesh",
    "make_chain_mesh",
    "make_hybrid_mesh",
    "make_pod_chain_mesh",
    "replicated",
    "sharded_chees_chain",
    "sharded_ess_chain",
    "sharded_abc_rejection",
    "sharded_gibbs_chain",
    "sharded_hmc_chain",
    "sharded_nuts_chain",
    "sharded_pt_chain",
    "sharded_smc",
    "sharded_vi",
]
