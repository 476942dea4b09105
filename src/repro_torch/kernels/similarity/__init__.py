from repro_torch.kernels.similarity.ops import (similarity_lookup,
                                                similarity_topk,
                                                similarity_topk_batched,
                                                similarity_topk_touch)
from repro_torch.kernels.similarity.ref import (similarity_lookup_ref,
                                                similarity_topk_batched_ref,
                                                similarity_topk_ref,
                                                similarity_topk_touch_ref)
