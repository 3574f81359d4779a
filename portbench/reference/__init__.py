"""The plain float32 references that decide ``correct``.

Plain PyTorch on the parameters and inputs the benchmark makes: no module,
kernel or helper of the program under test.  ``precision`` is the one switch:
``exact`` computes every matrix product and convolution in float32 (TF32
off), ``fp8`` rounds their operands to float8 e4m3 first, the control that a
comparison has to fail.
"""
