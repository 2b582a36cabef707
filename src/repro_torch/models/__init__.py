"""LM scaffolding: the reference's model code as plain functions on
tensors, with parameters in the reference's nested-dict tree."""
