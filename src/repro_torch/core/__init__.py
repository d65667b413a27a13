"""The paper's contribution: compressed decentralized SGD (DCD/ECD-PSGD)."""
from repro_torch.core.compression import (
    Compressor,
    HalfPrecisionCompressor,
    IdentityCompressor,
    RandomQuantizer,
    RandomSparsifier,
    TopKSparsifier,
    compressor_for,
    make_compressor,
    measured_alpha,
)
from repro_torch.core.topology import make_topology, spectral_info, check_mixing_matrix
from repro_torch.core.algorithms import (
    ALGORITHMS,
    Algorithm,
    AlgoState,
    GossipReference,
    average_model,
    consensus_distance,
    make_algorithm,
    mix,
)
