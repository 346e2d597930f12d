"""Model definitions (dense decoder path of ``repro.models``)."""
