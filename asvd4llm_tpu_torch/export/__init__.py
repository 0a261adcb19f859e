from asvd4llm_tpu_torch.export.checkpoint import (  # noqa: F401
    load_compressed, save_compressed,
)
from asvd4llm_tpu_torch.export.hf_repo import export_hf_repo  # noqa: F401
