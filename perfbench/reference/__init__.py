"""The plain reference the benchmark holds the port against.

Plain PyTorch and NumPy only: nothing here imports the port, JAX or the
JAX package.  ``threefry`` is a frozen copy of the counter-based PRNG
(jax's threefry2x32 layout), ``amper`` the AMPER-fr draw and its writes,
``dqn`` the DQN step on CartPole.
"""
