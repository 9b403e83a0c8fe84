"""The plain reference: the same semantics as the port's adjustment and
covariance, written from the model's equations in plain PyTorch (autograd
Jacobians, dense reduced system, LU solves), independent of the program.

It imports nothing of the program: it takes the network's arrays from the
benchmark's own generator and the program's outputs only to judge them."""
