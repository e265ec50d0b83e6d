"""The dense GQA decoder."""
