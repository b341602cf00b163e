"""The port's microbenchmarks: counterparts of the reference's tools/
labs that decided its kernels, run on the card."""
