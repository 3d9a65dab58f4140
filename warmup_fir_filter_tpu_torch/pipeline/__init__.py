"""The 5-stage verification pipeline: the artifact store, the stages
(the fixed-output stage on the port's kernels; the others numpy copies of
the JAX package's), reports and restore."""

from warmup_fir_filter_tpu_torch.pipeline.artifacts import ArtifactStore

__all__ = ["ArtifactStore"]
