"""Plain references: plain torch and numpy, nothing of the program."""
