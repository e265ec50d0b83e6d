"""The MaxEVA matmul (single-device slice)."""
