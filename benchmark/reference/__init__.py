"""The benchmark's plain reference: stencil operators, shifted operators,
residuals, sparse products on plain (rows, slots) arrays, and a plain
Jacobi-preconditioned conjugate gradient, in plain PyTorch. It imports
nothing of the program under test and takes nothing the program made
except the outputs it judges."""
