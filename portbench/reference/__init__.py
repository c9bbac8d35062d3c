"""Plain PyTorch definitions of the metrics the cells compute, one module a
metric, found by the name a traffic mix gives its member. They import neither
JAX nor anything of the program."""
