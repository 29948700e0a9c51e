"""Standalone applications: the compute / OpenCL / LBM regression analogs
and the tex / om / raster unit apps.  Counterpart of skybox_rt_tpu.apps."""
