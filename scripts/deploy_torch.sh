#!/usr/bin/env bash
# Staged deployment runbook of the PyTorch/CUDA port (role of the reference's
# runtime/triton_trtllm/run.sh, stages 0-5: convert -> build -> serve ->
# smoke -> bench); the counterpart of scripts/deploy.sh.
#
# Usage:
#   bash scripts/deploy_torch.sh <start_stage> <stop_stage> [model_dir]
#   bash scripts/deploy_torch.sh 0 5                  # random-init tiny config
#   bash scripts/deploy_torch.sh 0 5 /path/to/Spark-TTS-0.5B
#
# Env: SPARKTTS_PLATFORM=cpu runs every stage on the CPU (default: the card,
# and each stage raises without one); PORT (default 8959) and WORK (default
# $TMPDIR/sparktts_deploy_torch, else /tmp/sparktts_deploy_torch) as in
# deploy.sh.
#
# Stages (each prints "stage N OK" and its seconds):
#   0  load the checkpoint: read + convert, writing <model_dir>/_torch_cache/
#      (or build the random-init tiny config)
#   1  export deployment artifacts (export_pipeline_artifacts: .pt2 programs)
#   2  start scripts/run_server_torch.py in the background, wait for /health
#   3  offline smoke request through the network (the client module)
#   4  streaming smoke request (chunked /tts_stream)
#   5  mini offline benchmark (scripts/benchmark_torch.py)
# The server this script started is stopped when it exits, on success or
# failure (a trap on its saved pid), so stages 3-5 need stage 2 in the same
# run.
set -euo pipefail

START=${1:-0}
STOP=${2:-5}
MODEL_DIR=${3:-}
HOST=127.0.0.1
PORT=${PORT:-8959}
WORK=${WORK:-${TMPDIR:-/tmp}/sparktts_deploy_torch}
REPO="$(cd "$(dirname "$0")/.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
DEVICE=${SPARKTTS_PLATFORM:-cuda}
MODEL_ARG=""
TINY_ARG="--tiny"
if [ -n "$MODEL_DIR" ]; then
  MODEL_ARG="--model_dir $MODEL_DIR"
  TINY_ARG=""
fi

mkdir -p "$WORK"

SERVER_PID=""
stop_server() {
  if [ -n "$SERVER_PID" ] && kill -0 "$SERVER_PID" 2>/dev/null; then
    kill "$SERVER_PID" 2>/dev/null || true
    for _ in $(seq 1 50); do
      kill -0 "$SERVER_PID" 2>/dev/null || break
      sleep 0.2
    done
    kill -9 "$SERVER_PID" 2>/dev/null || true
    wait "$SERVER_PID" 2>/dev/null || true
    echo "server stopped (pid $SERVER_PID)"
  fi
  SERVER_PID=""
}
trap stop_server EXIT

run_stage() { [ "$START" -le "$1" ] && [ "$1" -le "$STOP" ]; }
now() { date +%s.%N; }
since() { python3 -c "import sys; print(f'{float(sys.argv[2]) - float(sys.argv[1]):.1f}')" "$1" "$(now)"; }

if run_stage 0; then
  echo "=== stage 0: checkpoint load / param cache"
  T0=$(now)
  python - "$MODEL_DIR" "$DEVICE" <<'EOF'
import sys
from sparktts_tpu_torch.checkpoint import flatten_tree
from sparktts_tpu_torch.cli import load_pipeline
model_dir, device = sys.argv[1] or None, sys.argv[2]
pipe = load_pipeline(model_dir, 24, device, prompt_bucket=32)
n = sum(t.numel() for t in flatten_tree(pipe.llm_params)[0].values())
where = f"checkpoint: {model_dir}, load seconds {pipe.load_seconds}" if model_dir else \
    "random-init tiny config"
print(f"stage 0 OK: params loaded on {pipe.device} ({where}), LM params {n / 1e6:.1f}M")
EOF
  echo "stage 0 seconds: $(since "$T0")"
fi

if run_stage 1; then
  echo "=== stage 1: export deployment artifacts -> $WORK/artifacts"
  T0=$(now)
  python - "$MODEL_DIR" "$DEVICE" "$WORK/artifacts" <<'EOF'
import sys
from sparktts_tpu_torch.cli import load_pipeline
from sparktts_tpu_torch.export import export_pipeline_artifacts
model_dir, device, out = sys.argv[1] or None, sys.argv[2], sys.argv[3]
pipe = load_pipeline(model_dir, 24, device, prompt_bucket=32)
manifest = export_pipeline_artifacts(pipe, out, wav_seconds=1.0, vocoder_tokens=50,
                                     prompt_len=32)
print(f"stage 1 OK: exported {sorted(manifest)} -> {out}")
EOF
  echo "stage 1 seconds: $(since "$T0")"
fi

if run_stage 2; then
  echo "=== stage 2: start HTTP server on :$PORT"
  T0=$(now)
  python "$REPO/scripts/run_server_torch.py" $MODEL_ARG --host $HOST --port $PORT \
    --max_new_tokens 24 --device "$DEVICE" > "$WORK/server.log" 2>&1 &
  SERVER_PID=$!
  echo "$SERVER_PID" > "$WORK/server.pid"
  for i in $(seq 1 600); do
    if python3 -c "import sys, urllib.request; urllib.request.urlopen(sys.argv[1], timeout=2)" \
        "http://$HOST:$PORT/health" > /dev/null 2>&1; then
      echo "stage 2 OK: server healthy (pid $SERVER_PID)"; break
    fi
    if ! kill -0 "$SERVER_PID" 2>/dev/null || [ "$i" = 600 ]; then
      echo "server failed to start"; tail -20 "$WORK/server.log"; exit 1
    fi
    sleep 0.5
  done
  echo "stage 2 seconds: $(since "$T0")"
fi

if run_stage 3; then
  echo "=== stage 3: offline smoke request"
  T0=$(now)
  python - "$WORK/prompt.wav" <<'EOF'
import sys
import numpy as np
from sparktts_tpu_torch.io.audio import write_wav
sr = 16000; t = np.arange(sr) / sr
write_wav(sys.argv[1], (0.3 * np.sin(2 * np.pi * 240 * t)).astype(np.float32), sr)
EOF
  python -m sparktts_tpu_torch.serve.client --host $HOST --port $PORT \
    --text "deployment smoke test" --prompt-wav "$WORK/prompt.wav" \
    --output "$WORK/smoke_offline.wav"
  echo "stage 3 OK"
  echo "stage 3 seconds: $(since "$T0")"
fi

if run_stage 4; then
  echo "=== stage 4: streaming smoke request"
  T0=$(now)
  python -m sparktts_tpu_torch.serve.client --host $HOST --port $PORT \
    --text "streaming smoke test" --prompt-wav "$WORK/prompt.wav" \
    --stream --output "$WORK/smoke_stream.wav"
  echo "stage 4 OK"
  echo "stage 4 seconds: $(since "$T0")"
fi

if run_stage 5; then
  echo "=== stage 5: mini offline benchmark"
  T0=$(now)
  python "$REPO/scripts/benchmark_torch.py" $MODEL_ARG $TINY_ARG --device "$DEVICE" \
    --num_synthetic 2 --max_new_tokens 24 --output "$WORK/bench.json" | tail -12
  echo "stage 5 OK: stats in $WORK/bench.json"
  echo "stage 5 seconds: $(since "$T0")"
fi

stop_server
echo "deploy_torch.sh: stages $START-$STOP complete (work dir: $WORK)"
