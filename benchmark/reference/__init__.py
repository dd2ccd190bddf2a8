"""Plain references, one module a configuration's model; they import
nothing of the program."""
