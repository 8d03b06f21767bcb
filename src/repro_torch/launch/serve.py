"""Deprecated alias for :mod:`repro_torch.launch.serve_lm` (as
``repro.launch.serve`` is for ``repro.launch.serve_lm``): the LM
prefill/decode driver, named apart from :mod:`repro_torch.serve`, the
always-on CGRA kernel serving engine. Import from the new location.
"""
from repro_torch.launch.serve_lm import generate, main  # noqa: F401

if __name__ == "__main__":
    main()
