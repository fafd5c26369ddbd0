"""Sample-quality evaluation for SC09: FID and Inception Score (the
SaShiMi paper's metric, arXiv:2202.09729 §4), the scoring classifier, the
synthetic corpus, the scoring CLI (:mod:`.sc09_eval`) and the flagship
train-then-score loop (:mod:`.flagship`).  Port of
``diffwave_sashimi_tpu/eval``, with the same exports."""

from .fid import frechet_distance, gaussian_stats, inception_score

__all__ = ["frechet_distance", "gaussian_stats", "inception_score"]
