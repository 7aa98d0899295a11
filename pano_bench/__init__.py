"""The benchmark of pano_tpu_torch, the PyTorch and CUDA port.

One command runs one cell once, on the CUDA devices of the machine it
starts on:

    python3 -m pano_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``BENCHMARK.json`` at the repository root names the cells, the
configurations and the metrics; everything that belongs to one of them
is a file of its own under this folder, found by its name:

* ``configs/<config>.json``: the deployment (image sizes, the pipeline's
  options, what was assumed or reduced), and ``limits/<config>.json``
  the limits of the comparison that decides ``correct``;
* ``traffic/<traffic>.json``: the mix one of the general loops reads
  (the pool's planted geometry, depth, batch, sampling, which pairs a
  panorama estimates), the loop named by its "driver": one of
  ``drivers.py``, or a file ``loops/<driver>.py`` of its own;
* ``scene_models/<scene>.py``: how the pool's scenes are made and
  planted, named by the traffic's "scene": ``crops`` (crops of one
  texture at the traffic's offsets, the model where it names none) or
  ``rotating`` (a camera rotating about its centre, at the traffic's
  poses);
* ``metrics/<metric>.py``: a per-layer metric's reader of the trace (the
  harness's layer spans, the program's ``pano.`` ranges, the device),
  or of the untraced window that a traced run makes first where a
  per-layer metric is taken on the host's clock (``window.*``);
* ``tests/shrunk/<cell>.json``: a cell's sizes for the CPU tests;
* ``kernel_steps.json`` and ``spans.json``: which trace kernels belong
  to which step of the roofline, and which program calls get a layer
  span.

The harness imports ``pano_tpu_torch`` and nothing else of the
repository.
"""
