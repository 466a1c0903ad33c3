"""python -m honours_tpu_torch.bench [--device cuda|cpu]: the benchmark
driver's one JSON line (bench/driver.py), run from the repository root."""

from honours_tpu_torch.bench.driver import main

if __name__ == "__main__":
    main()
