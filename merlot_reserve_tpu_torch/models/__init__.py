from merlot_reserve_tpu_torch.models.model import MerlotReserve, PretrainedMerlotReserve
from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer

__all__ = ["MerlotReserve", "MerlotReservePretrainer", "PretrainedMerlotReserve"]
