"""The plain reference of the benchmark's models (fp32 torch, no program
code) and the control one precision below it."""
