from asvd4llm_tpu_torch.serving.paged import (  # noqa: F401
    init_paged_pools, paged_decode_step, pages_needed, prefill_into_pages,
)
from asvd4llm_tpu_torch.serving.engine import PagedEngine  # noqa: F401
