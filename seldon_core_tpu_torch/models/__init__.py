"""Model zoo + prepackaged servers (``CudaServer``, the generation
components, the sklearn / xgboost / mlflow / TorchScript servers and the
proxies), each named in the graph registry of ``engine/units.py`` as
the JAX package names it.  Importing this package imports nothing."""
