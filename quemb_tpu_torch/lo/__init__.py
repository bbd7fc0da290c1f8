from quemb_tpu_torch.lo.lowdin import lowdin_localize, lowdin_orth

__all__ = ["lowdin_orth", "lowdin_localize"]
