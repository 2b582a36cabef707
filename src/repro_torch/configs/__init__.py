"""Model configurations of the LM scaffolding (the reference's, copied)."""
