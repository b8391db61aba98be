from hypre_tpu_torch.krylov.pcg import pcg
