"""The plain reference of a WPFed round, written with torch operations
alone: batched matrix products for the client models (convolutions as
im2col products, no cuDNN), explicit autograd and Adam, the Eq. 5-8
selection, the §3.5 exchange and the announce. It imports neither JAX,
the JAX package nor anything of the port: it reads only the inputs the
benchmark made (`portbench.inputs`) and the port's outputs, which it
judges.
"""
