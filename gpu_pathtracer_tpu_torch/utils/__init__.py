"""Host side of the port: master-file parsing, OBJ/MTL loading, image
writing, generated test scenes and the loader of the native host library.
Plain numpy/Python; the port's own copies of the modules of the same names in
`gpu_pathtracer_tpu.utils` (`tests/test_torch_host.py` holds each pair equal).
"""
