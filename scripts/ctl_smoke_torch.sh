#!/usr/bin/env bash
# Control-plane smoke of the port (`python -m repro_torch.ctl`): exercise the
# daemon's whole online story end to end against a throwaway state dir —
# submit two jobs, watch them run, cancel one, kill -9 the daemon
# mid-flight, restart it and verify the interrupted job recovers and
# finishes.  The port of scripts/ctl_smoke.sh; the daemon simulates its
# default profile, h100 (DeviceSpec.h100_like).  The serving job's window
# is 40 simulated seconds, not the reference's 6: once the training job is
# cancelled the daemon simulates the serving job alone at several simulated
# seconds a wall second, and 6 could end before the kill below on a fast
# host, which leaves no interrupted job to recover.  Run under `timeout` from CI
# (the script itself polls with bounded loops so a wedged daemon fails, not
# hangs):  timeout 120 bash scripts/ctl_smoke_torch.sh
set -euo pipefail

DIR=$(mktemp -d "${TMPDIR:-/tmp}/ctl-smoke-torch.XXXXXX")
trap 'kill -9 $DPID 2>/dev/null || true; rm -rf "$DIR"' EXIT
CTL="python -m repro_torch.ctl"
export PYTHONPATH=${PYTHONPATH:-src}

state_of() { $CTL status --state-dir "$DIR" --json \
  | python -c "import json,sys; d=json.load(sys.stdin); \
print(next((j['state'] for j in d['jobs'] if j['job_id']=='$1'), 'absent'))"; }

wait_state() {     # job_id  want  tries
  for _ in $(seq "${3:-150}"); do
    s=$(state_of "$1")
    [ "$s" = "$2" ] && return 0
    sleep 0.2
  done
  echo "FAIL: $1 stuck in '$s' (wanted $2)"; $CTL status --state-dir "$DIR"
  return 1
}

echo "== submit two jobs, start the daemon =="
JOB_A=$($CTL submit --state-dir "$DIR" --kind serve --rps 25 --duration 40 \
        --priority hp --quota 6 --name svc-a)
JOB_B=$($CTL submit --state-dir "$DIR" --kind train --duration 40 --name trn-b)
$CTL daemon --state-dir "$DIR" --devices 2 & DPID=$!

wait_state "$JOB_A" running
wait_state "$JOB_B" running
$CTL status --state-dir "$DIR"

echo "== cancel one job while it runs =="
$CTL cancel --state-dir "$DIR" "$JOB_B"
wait_state "$JOB_B" cancelled

echo "== kill -9 the daemon mid-flight =="
kill -9 "$DPID"; wait "$DPID" 2>/dev/null || true
S_A=$(state_of "$JOB_A")
[ "$S_A" = running ] || { echo "FAIL: journal lost $JOB_A (state $S_A)"; exit 1; }

echo "== restart: recovery must resume and finish the interrupted job =="
$CTL daemon --state-dir "$DIR" --devices 2 --exit-when-idle --max-wall 240
wait_state "$JOB_A" done 5
$CTL status --state-dir "$DIR"

RECOVERIES=$($CTL status --state-dir "$DIR" --json \
  | python -c "import json,sys; d=json.load(sys.stdin); \
print(next(j['recoveries'] for j in d['jobs'] if j['job_id']=='$JOB_A'))")
[ "$RECOVERIES" = 1 ] || { echo "FAIL: expected 1 recovery, got $RECOVERIES"; exit 1; }
echo "ctl smoke OK (job $JOB_A recovered once, cancel honored, no loss)"
