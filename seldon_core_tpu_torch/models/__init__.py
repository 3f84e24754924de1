"""Model zoo + prepackaged servers (this slice: the ResNet family and
``CudaServer``).  Importing this package imports nothing."""
