"""The plain references, one module a configuration; plain torch that
imports nothing of the program."""
