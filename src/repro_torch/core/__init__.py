# The paper's primary contribution: the CoIC edge cache (PyTorch port).
from repro_torch.core.cluster import (ClusterConfig,
                                      CooperativeEdgeCluster)
from repro_torch.core.coic import CoICConfig, CoICEngine, RequestResult
from repro_torch.core.descriptor import (NgramSketchDescriptor,
                                         PrefixDescriptor, l2_normalize)
from repro_torch.core.hash_cache import HashCache
from repro_torch.core.layer_reuse import (BlockReuseCache, BlockReuseStats,
                                          SemOffsetEntry)
from repro_torch.core.network import NetworkModel
from repro_torch.core.policies import EvictionPolicy
from repro_torch.core.semantic_cache import SemanticCache, SemanticCacheState
from repro_torch.core.tiers import (TIER_LOCAL, TIER_MISS, TIER_NAMES,
                                    TIER_PEER, TIER_REMOTE, CacheTier,
                                    LadderResult, TierLadder, TierProbeResult)
