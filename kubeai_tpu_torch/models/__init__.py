"""Model families. Counterpart of kubeai_tpu/models."""

from kubeai_tpu_torch.models.registry import ModelFamily, get_model_family

__all__ = ["ModelFamily", "get_model_family"]
