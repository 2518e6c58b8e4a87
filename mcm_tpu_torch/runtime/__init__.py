"""Native host runtime: the C++ libjpeg batch decoder (``decoder.cpp``)
and its loader (:mod:`mcm_tpu_torch.runtime.native`)."""
