"""Models: the filter banks, the numpy golden oracle and the DSP chain."""
