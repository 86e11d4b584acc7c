"""merlot_reserve_tpu_torch: the PyTorch/CUDA port of merlot_reserve_tpu.

A package of its own: it imports torch and numpy and nothing of JAX or of
the JAX package. Its entry points (``models.model.MerlotReserve``,
``PretrainedMerlotReserve.from_params``, ``serving.VideoEmbedService``) run
on the CUDA card unless the caller passes ``device="cpu"``. The joint
transformer's attention runs in the hand-written kernel ``csrc/flash_fwd.cu``
on the card. Importing the package builds nothing and touches no device.
"""

from merlot_reserve_tpu_torch.config import MerlotConfig, ModelConfig, load_config

__all__ = ["MerlotConfig", "ModelConfig", "load_config"]
