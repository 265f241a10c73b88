"""Wire vocabulary the port's device code needs (enums only)."""
