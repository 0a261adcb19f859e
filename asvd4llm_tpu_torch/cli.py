"""CLI entry point: ``python -m asvd4llm_tpu_torch.cli --model_id <dir> ...``.

The flag surface is the JAX package's (one flag per ASVDConfig field). The
run goes to ``cuda:0``; ``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import logging
import sys


def main(argv=None, *, device=None):
    """Parse flags, run the pipeline, print the results; returns the
    pipeline's output dict (see pipeline.run)."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    from asvd4llm_tpu_torch.config import config_from_args
    from asvd4llm_tpu_torch.pipeline import run

    cfg = config_from_args(argv)
    out = run(cfg, device=device)
    print(out["results"])
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
