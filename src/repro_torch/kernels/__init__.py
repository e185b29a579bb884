# Default kernel tile geometry: it = row-tile height, dt = diagonal-tile
# width, the reference's values (`repro/kernels/__init__.py`). They stay
# plan fields so the port's plans compare field by field with the
# reference's. The port uses them only to pad the streams exactly as the
# reference does (rows to a multiple of `it`, the diagonal span to a
# multiple of `dt`), so both packages hand their kernels identical arrays;
# the CUDA kernel tiles its own way (kernels/csrc/natsa_mp.cu). This module
# imports nothing, so the planner can read the defaults cheaply.
DEFAULT_IT = 256
DEFAULT_DT = 8
