"""Tools (port of the repository's ``tools/``): the kernel bench."""
