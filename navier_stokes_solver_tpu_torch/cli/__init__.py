"""Command-line programs mirroring the reference binaries.

``python -m navier_stokes_solver_tpu_torch.cli.unsteady``    ~ ``./NSSolver``
(test.cpp:21-155) and
``python -m navier_stokes_solver_tpu_torch.cli.stationary``  ~ ``./StationaryNSSolver``
(testStationary.cpp:19-139), with the JAX package's flags, defaults and
config echo, plus ``--device`` (default ``cuda``; ``--device cpu`` runs on
the CPU).
"""
