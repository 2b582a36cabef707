"""Launch-side helpers: the H100 roofline constants and the kernels'
task-intrinsic work counts."""
