"""The benchmark's plain reference of the closed-loop MPC period.

Plain PyTorch, written from the published controller (Pigeon.jl's X1CMPC
and X1DMPC with the X1 vehicle) and frozen with the benchmark: it imports
neither JAX nor the JAX package nor anything of the program under test,
and takes nothing the program has made.  The harness hands it the same
inputs it hands the program (states, commands, times, the other car, the
path's columns, the value grid's file) and the program's outputs, which
it only judges.

It runs in float64.  `precision.Arith` also runs it in float32 with every
matrix product's operands rounded to TF32, the control that the
comparison has to reject (`benchmark/control.py`).
"""
