"""The subprocess that runs the user's function inside a Spark executor
(the port's copy of ``horovod_tpu/spark/task_exec.py``, after upstream
Horovod's ``spark/task/mpirun_exec_fn.py``).

``SparkTaskService`` starts ``python -m horovod_tpu_torch.spark.task_exec
PAYLOAD`` with the job's ``HOROVOD_*`` block in its environment: it loads
the pickled ``(fn, args, kwargs)``, runs ``fn`` and writes the pickled
result to ``PAYLOAD.out``. ``hvd.init()`` inside ``fn`` joins the world as
a worker of the launcher would.
"""

import sys


def pickler():
    """The module that carries functions and results: cloudpickle where it
    is installed (closures and lambdas travel by value), else pyspark's
    copy of it, else plain pickle, which carries a function by its module
    and name only (so a function must be importable where it runs)."""
    try:
        import cloudpickle
        return cloudpickle
    except ImportError:
        pass
    try:
        from pyspark import cloudpickle
        return cloudpickle
    except ImportError:
        import pickle
        return pickle


def main(payload_path: str) -> int:
    p = pickler()
    with open(payload_path, "rb") as f:
        fn, args, kwargs = p.loads(f.read())
    result = fn(*args, **kwargs)
    with open(payload_path + ".out", "wb") as f:
        f.write(p.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
