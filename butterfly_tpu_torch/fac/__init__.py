from butterfly_tpu_torch.fac.uniformize import FusedFacPlan, uniformize_fused

__all__ = ["FusedFacPlan", "uniformize_fused"]
