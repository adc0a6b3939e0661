"""Plain fp32 references of what the cells serve and train; they import
nothing of the program."""
