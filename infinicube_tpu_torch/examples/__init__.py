"""Scripts that chain the port's stages: ``e2e_pipeline`` and
``e2e_stage3_resume``."""
