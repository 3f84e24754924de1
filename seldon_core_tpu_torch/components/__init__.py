"""Reusable graph components: learned routers (``EPSILON_GREEDY``,
``THOMPSON_SAMPLING``), the outlier detectors (``OUTLIER_MAHALANOBIS``,
``OUTLIER_VAE``, ``OUTLIER_ISOLATION_FOREST``, ``OUTLIER_SEQ2SEQ``) and
the explainers, each named in the graph registry of ``engine/units.py``
as the JAX package names them.  Importing this package imports
nothing."""
