"""Architecture configs: the reference's ten, field for field."""
