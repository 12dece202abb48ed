"""Host tools: the stage pipeline and the reference-checkpoint converter."""
