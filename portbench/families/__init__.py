"""How each model family meets the program: one module per family, named by
a configuration's ``family`` key.

A family module gives the program's model for a configuration, its served
predictor, its train objective, the signals its traffic sends, and the plain
reference's outputs on the same signals (``reference/<family>.py``).  The
program (``eyegaze_tpu_torch``) is imported inside the functions only.
"""
