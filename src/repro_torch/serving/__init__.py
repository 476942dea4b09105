from repro_torch.serving.engine import (PromptTooLongError, ServingConfig,
                                        ServingEngine)
from repro_torch.serving.kv_cache import (PagedKVCache, batch_cache_insert,
                                          batch_cache_scatter,
                                          init_batch_cache, init_paged_pool)
