"""ekaid_torch: the difference-VQA model in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (H100).

The port of `ekaid_tpu` (JAX on TPU), which stays beside it as the
reference. The port imports neither JAX nor `ekaid_tpu`. Its entry
points (`EkaidModel`, `InferenceEngine`) run on the CUDA device unless
the caller passes device='cpu'.
"""

from ekaid_torch.config import Config, default_config, load_config

__all__ = ["Config", "default_config", "load_config"]
