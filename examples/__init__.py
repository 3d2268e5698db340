"""Worked examples — JAX analogs of the reference's examples/
directory (SURVEY.md section 2.6): MNIST one-vs-all SVM, convergence
checking with deliberately broken proxes, fast-ADMM comparison, step-size
and relaxation studies, H-norm stopping demo, and the parallel-vs-serial
unwrapped-ADMM benchmark."""
