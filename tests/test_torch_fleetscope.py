"""The router's fleet scope in the port (``serving/fleetscope.py``, a
scripted copy): every scenario of the JAX package's
``tests/test_fleetscope.py``, re-pointed at the port
(:mod:`torch_ported`)."""

from torch_ported import exec_ported

exec_ported("test_fleetscope.py", globals())
