from repro_torch.serving.engine import (PromptTooLongError, ServingConfig,
                                        ServingEngine)
from repro_torch.serving.kv_cache import PagedKVCache, init_paged_pool
