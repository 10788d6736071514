"""The plain reference of the benchmark's configurations.

Plain NumPy and PyTorch in float64, written for this benchmark and
independent of the program: the ellipse discretization, the Hankel
functions (`hankel.py`, from DLMF's series), the Kapur-Rokhlin weights
(`kr.py`, a frozen copy of the published table), the dense boundary
integral systems and operators (`bie.py`) and the comparisons that decide
`correct`. Nothing here imports the program, JAX or the JAX package.
"""
