"""Gravity models (counterpart of ``elodin_tpu/gravity``): EGM2008
spherical harmonics (``egm08``).  ``j2`` is not ported."""
