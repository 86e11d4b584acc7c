from merlot_reserve_tpu_torch.models.model import MerlotReserve, PretrainedMerlotReserve

__all__ = ["MerlotReserve", "PretrainedMerlotReserve"]
