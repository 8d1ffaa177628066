from sigma_tpu_torch.eigen.lobpcg import LOBPCGResult, lobpcg

__all__ = ["LOBPCGResult", "lobpcg"]
