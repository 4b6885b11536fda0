"""Evaluation metrics (counterpart of spgan_tpu/evalkit/): FID and the
Inception Score on pytorch-fid's InceptionV3, and LPIPS (alex v0.1).
``python -m spgan_tpu_torch.evalkit`` is the offline CLI."""
from spgan_tpu_torch.evalkit.fid import (  # noqa: F401
    FIDEvaluator,
    FIDStats,
    compute_stats,
    eval_fid,
    frechet_distance,
)
from spgan_tpu_torch.evalkit.inception import InceptionV3FID  # noqa: F401
from spgan_tpu_torch.evalkit.is_score import inception_score  # noqa: F401
from spgan_tpu_torch.evalkit.lpips import LPIPS  # noqa: F401
