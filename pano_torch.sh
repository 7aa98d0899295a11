#!/bin/bash
# Driver CLI of the PyTorch + CUDA port (pano_tpu_torch), with pano.sh's
# subcommands (pano.sh stays the JAX package's): build | run | perf |
# eval | serve | help. Implementations are execution configs of the one
# library:
#   serial  -> every stage on the CPU, each kernel's plain PyTorch version
#   openmp  -> sharded: the batched and multi-device path (parallel/shard.py)
#   gpu|tpu -> one CUDA device, the hand-written kernels
#   opencv  -> cv::Stitcher baseline

SCRIPT_DIR="$( cd "$( dirname "${BASH_SOURCE[0]}" )" &> /dev/null && pwd )"
PYTHON="${PYTHON:-python3}"
NO_GPU=false

usage() {
    echo "Usage:"
    echo "  $0 build [--no-gpu]"
    echo "      Build the CUDA kernels (nvcc) and check the environment"
    echo "      --no-gpu: only check that the package imports on the CPU"
    echo ""
    echo "  $0 run <implementation> <image1> <image2> [<image3> ...] [options]"
    echo "      Run an implementation with image files"
    echo "      implementation: serial, openmp (sharded), gpu/tpu, opencv"
    echo ""
    echo "  $0 perf <implementation> <image1> <image2> [<image3> ...] [options]"
    echo "      Run under torch.profiler; writes <impl>_perf_report.txt and"
    echo "      a Chrome trace directory for deep analysis"
    echo ""
    echo "  $0 eval <generated_panorama> <reference_panorama>"
    echo "      Evaluate stitching quality against a reference panorama"
    echo ""
    echo "  $0 serve <implementation> [default options] < jobs.txt"
    echo "      Persistent serving loop: one warm process, one job per stdin"
    echo "      line (same argument surface as 'run'); amortizes start-up and"
    echo "      the kernels' first launches across jobs. 'quit' or EOF ends."
    echo ""
    echo "Options for 'run' and 'perf':"
    echo "  --dir <directory>      Use all images in the specified directory"
    echo "  --out <filename>       Output filename (default: result.jpg)"
    echo "  --no-gpu               Run on the CPU (PANO_TPU_FORCE_CPU=1)"
    echo "  (plus pipeline flags: --mode, --blend, --bundle, --timing total|stages, --parity, --json, ...)"
    echo ""
    echo "Examples:"
    echo "  $0 run gpu images/mountain/mountain1.jpg images/mountain/mountain2.jpg"
    echo "  $0 run serial --dir images/oilseed/ --out oilseed_panorama.jpg"
    echo "  $0 eval result.jpg images/oilseed-ref.jpg"
    exit 1
}

if [ $# -lt 1 ]; then
    usage
fi

COMMAND=$1
shift

# Strip the driver-level option shared by run/perf/serve: --no-gpu asks
# for the CPU.
process_common_args() {
    COMMON_ARGS=()
    while [ $# -gt 0 ]; do
        case $1 in
            --no-gpu)
                NO_GPU=true
                ;;
            *)
                COMMON_ARGS+=("$1")
                ;;
        esac
        shift
    done
}

run_env() {
    # Environment for pano_tpu_torch.cli invocations, honoring --no-gpu.
    ENV_VARS=(PYTHONPATH="$SCRIPT_DIR:$PYTHONPATH")
    $NO_GPU && ENV_VARS+=(PANO_TPU_FORCE_CPU=1)
}

case $COMMAND in
    build)
        process_common_args "$@"
        echo "=== Building pano_tpu_torch ==="
        cd "$SCRIPT_DIR" || exit 1
        BUILD_ENV=()
        $NO_GPU && BUILD_ENV=(env PANO_TPU_FORCE_CPU=1)
        "${BUILD_ENV[@]}" "$PYTHON" - <<'EOF' || { echo "Build check failed"; exit 1; }
import os
import torch
import pano_tpu_torch
print(f"torch {torch.__version__}, CUDA available: "
      f"{torch.cuda.is_available()}, devices: {torch.cuda.device_count()}")
if not os.environ.get("PANO_TPU_FORCE_CPU"):
    from pano_tpu_torch import _build
    _build.lib()
    print(f"kernels: {_build.LIB_PATH}")
EOF
        echo "=== Build check completed successfully ==="
        ;;

    run)
        if [ $# -lt 1 ]; then
            echo "Error: Missing implementation"
            usage
        fi
        IMPL=$1
        shift
        process_common_args "$@"
        run_env
        echo "Running $IMPL implementation..."
        env "${ENV_VARS[@]}" "$PYTHON" -m pano_tpu_torch.cli "$IMPL" "${COMMON_ARGS[@]}"
        RC=$?
        if [ $RC -eq 0 ]; then
            echo "Stitching completed successfully!"
        else
            echo "Stitching failed with error code $RC"
        fi
        exit $RC
        ;;

    serve)
        if [ $# -lt 1 ]; then
            echo "Error: Missing implementation"
            usage
        fi
        IMPL=$1
        shift
        process_common_args "$@"
        run_env
        env "${ENV_VARS[@]}" "$PYTHON" -m pano_tpu_torch.cli serve "$IMPL" "${COMMON_ARGS[@]}"
        ;;

    perf)
        if [ $# -lt 1 ]; then
            echo "Error: Missing implementation"
            usage
        fi
        IMPL=$1
        shift
        process_common_args "$@"
        run_env
        # PANO_TPU_TRACE_DIR overrides the trace location.
        TRACE_DIR="${PANO_TPU_TRACE_DIR:-${SCRIPT_DIR}/${IMPL}_perf_trace}"
        echo "Running performance profiling on $IMPL implementation..."
        env "${ENV_VARS[@]}" PANO_TPU_PROFILE="$TRACE_DIR" \
            "$PYTHON" -m pano_tpu_torch.cli "$IMPL" "${COMMON_ARGS[@]}" | tee "${IMPL}_perf_report.txt"
        RC=${PIPESTATUS[0]}
        if [ $RC -eq 0 ]; then
            echo "Performance profiling completed successfully!"
            echo "Performance report saved to ${IMPL}_perf_report.txt"
            echo "Profiler trace (Chrome trace) saved to ${TRACE_DIR}"
            # Per-kernel device-time table appended to the report (a pair
            # runs some 60 kernels a stream, the port's own among them).
            if "$PYTHON" "${SCRIPT_DIR}/tools/torch_trace_summary.py" \
                    "$TRACE_DIR" --top 100 >> "${IMPL}_perf_report.txt"; then
                echo "Per-kernel device summary appended to ${IMPL}_perf_report.txt"
            fi
        else
            echo "Performance profiling failed with error code $RC"
        fi
        exit $RC
        ;;

    eval)
        if [ $# -lt 2 ]; then
            echo "Error: Missing panorama images"
            echo "Usage: $0 eval <generated_panorama> <reference_panorama>"
            exit 1
        fi
        GENERATED_PANORAMA=$1
        REFERENCE_PANORAMA=$2
        if [ ! -f "$GENERATED_PANORAMA" ]; then
            echo "Error: Generated panorama file not found: $GENERATED_PANORAMA"
            exit 1
        fi
        if [ ! -f "$REFERENCE_PANORAMA" ]; then
            echo "Error: Reference panorama file not found: $REFERENCE_PANORAMA"
            exit 1
        fi
        echo "Evaluating panorama quality..."
        PYTHONPATH="$SCRIPT_DIR:$PYTHONPATH" "$PYTHON" \
            "$SCRIPT_DIR/evaluate_panorama_torch.py" "$GENERATED_PANORAMA" "$REFERENCE_PANORAMA"
        RC=$?
        if [ $RC -eq 0 ]; then
            echo "Evaluation completed successfully!"
        else
            echo "Evaluation failed with error code $RC"
        fi
        exit $RC
        ;;

    help)
        usage
        ;;

    *)
        echo "Unknown command: $COMMAND"
        usage
        ;;
esac
