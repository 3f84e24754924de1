"""Reusable graph components: learned routers (``EPSILON_GREEDY``,
``THOMPSON_SAMPLING``, named in the graph registry of
``engine/units.py``).  Importing this package imports nothing.  The
outlier detectors and explainers are not ported (``ROADMAP.md`` §A
item 11)."""
